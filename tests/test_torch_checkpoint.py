"""The port's checkpoints (`repro_torch.ckpt.checkpoint`) against the JAX
package's, on the CPU.

* The reference's six behaviours (`tests/test_substrate.py`): round trip,
  gc of all but the newest, the sweep of crashed saves' ``.tmp-*``, and
  the strict restore's refusals (tree, truncated buffer, dtype), with the
  reference's messages.
* The manifest codec: byte-equal to ``msgpack.packb`` (hypothesis) and
  decoding what ``msgpack`` writes.
* Files: the same tree written by both packages gives the same bytes, a
  reduced bf16 model's weights among them (JAX's layout, carried as
  tensors); each package restores the other's; the port's own parameter
  tree round-trips, bf16 leaves as ``torch.bfloat16``.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)


def _files(path):
    out = {}
    for f in ("manifest.msgpack", "arrays.bin"):
        with open(os.path.join(path, f), "rb") as fh:
            out[f] = fh.read()
    return out


# ================================================== the reference's cases
def case_roundtrip(d):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    checkpoint.save(d, 7, tree)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.bfloat16)}}
    got, step = checkpoint.restore(d, like)
    assert step == 7
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])


def case_gc_keeps_newest(d):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, tree, keep=2)
    assert checkpoint.latest_step(d) == 5
    assert sorted(int(x) for x in os.listdir(d) if x.isdigit()) == [4, 5]


def case_sweeps_stale_tmp_dirs(d):
    """A crashed save leaves .tmp-<step>; the next save sweeps it, and a
    retried save of the same step overwrites its own leftover."""
    tree = {"a": torch.zeros(2)}
    os.makedirs(os.path.join(d, ".tmp-3"))
    with open(os.path.join(d, ".tmp-3", "arrays.bin"), "wb") as f:
        f.write(b"partial")
    checkpoint.save(d, 3, tree)
    checkpoint.save(d, 4, tree)
    assert not [x for x in os.listdir(d) if x.startswith(".tmp-")]
    _, step = checkpoint.restore(d, {"a": np.zeros(2, np.float32)})
    assert step == 4


def case_rejects_treedef_mismatch(d):
    checkpoint.save(d, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="treedef mismatch"):
        checkpoint.restore(d, {"a": torch.zeros(2), "b": torch.zeros(3)})


def case_rejects_truncated_file(d):
    checkpoint.save(d, 1, {"a": torch.arange(8, dtype=torch.float32)})
    path = os.path.join(d, "1", "arrays.bin")
    with open(path, "rb") as f:
        buf = f.read()
    with open(path, "wb") as f:
        f.write(buf[:-4])
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.restore(d, {"a": torch.zeros(8)})


def case_rejects_dtype_drift(d):
    """uint32 key rows restored into a float32 target raise instead of
    reinterpreting bits; shapes too."""
    checkpoint.save(d, 1, {"key": np.zeros((2, 2), np.uint32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        checkpoint.restore(d, {"key": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(d, {"key": np.zeros((4,), np.uint32)})
    got, _ = checkpoint.restore(d, {"key": np.zeros((2, 2), np.uint32)})
    assert got["key"].dtype == np.uint32
    got, _ = checkpoint.restore(d, {"key": torch.zeros(
        2, 2, dtype=torch.uint32)})
    assert got["key"].dtype == torch.uint32


CASES = [case_roundtrip, case_gc_keeps_newest, case_sweeps_stale_tmp_dirs,
         case_rejects_treedef_mismatch, case_rejects_truncated_file,
         case_rejects_dtype_drift]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_reference_checkpoint_behaviours(case, tmp_path):
    case(str(tmp_path / "ck"))


def test_error_messages_are_the_reference_ones(tmp_path):
    """The same bad restore raises the same message in both packages."""
    for pkg, tree in ((jckpt, {"k": jnp.zeros((2, 2), jnp.uint32)}),
                      (checkpoint, {"k": np.zeros((2, 2), np.uint32)})):
        d = str(tmp_path / pkg.__name__)
        pkg.save(d, 1, tree)
    msgs = []
    for pkg in (jckpt, checkpoint):
        d = str(tmp_path / pkg.__name__)
        row = []
        for like in ({"k": np.zeros((2, 2), np.float32)},
                     {"k": np.zeros((2, 2), np.uint32),
                      "z": np.zeros(1, np.float32)}):
            with pytest.raises(ValueError) as err:
                pkg.restore(d, like)
            row.append(str(err.value))
        msgs.append(row)
    assert msgs[0] == msgs[1]


# ================================================================= codec
_leaf = (st.none() | st.integers(0, 2 ** 64 - 1)
         | st.text(max_size=40) | st.text(min_size=250, max_size=300))
_values = st.recursive(
    _leaf, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=40)


@settings(max_examples=60, deadline=None)
@given(_values)
def test_codec_is_msgpack(obj):
    raw = msgpack.packb(obj)
    assert checkpoint.packb(obj) == raw
    assert checkpoint.unpackb(raw) == msgpack.unpackb(raw)


def test_codec_refuses_what_it_cannot_write():
    for bad in (-1, 1.5, True, b"x", 2 ** 64):
        with pytest.raises((TypeError, ValueError, OverflowError)):
            checkpoint.packb(bad)
    with pytest.raises(ValueError, match="outside"):
        checkpoint.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.unpackb(msgpack.packb("abcdef")[:-2])


# ================================================================= files
def test_both_packages_write_the_same_bytes(tmp_path):
    """Every dtype the fleet and training write, nested dicts, lists and a
    tuple: the two packages' files are byte-equal, and each restores the
    other's."""
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "i32": np.asarray(7, np.int32),
              "u32": rng.integers(0, 2 ** 32, (4, 2), dtype=np.uint32),
              "i64": np.arange(3, dtype=np.int64),
              "f64": rng.standard_normal(2)}
    jtree = ({"b": [jnp.asarray(arrays["f32"]), jnp.asarray(arrays["i32"])],
              "a": {"u": jnp.asarray(arrays["u32"])}},
             arrays["i64"], arrays["f64"])       # JAX holds no 64-bit
    ttree = ({"b": [torch.from_numpy(arrays["f32"]),
                    torch.from_numpy(arrays["i32"])],
              "a": {"u": torch.from_numpy(arrays["u32"])}},
             torch.from_numpy(arrays["i64"]), arrays["f64"])
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    checkpoint.save(str(tmp_path / "p"), 3, ttree)
    assert _files(tmp_path / "j" / "3") == _files(tmp_path / "p" / "3")
    like = jax.tree.map(np.zeros_like, jtree)
    got, _ = jckpt.restore(str(tmp_path / "p"), like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert np.array_equal(a, np.asarray(b))
    tlike = ({"b": [torch.zeros(3, 5), torch.zeros((), dtype=torch.int32)],
              "a": {"u": torch.zeros(4, 2, dtype=torch.uint32)}},
             torch.zeros(3, dtype=torch.int64), np.zeros(2))
    got, _ = checkpoint.restore(str(tmp_path / "j"), tlike)
    assert isinstance(got, tuple) and isinstance(got[0]["b"], list)
    assert torch.equal(got[0]["a"]["u"], ttree[0]["a"]["u"])
    assert torch.equal(got[0]["b"][1], ttree[0]["b"][1])
    assert np.array_equal(got[2], arrays["f64"])


def test_bf16_params_byte_equal_across_packages(tmp_path):
    """A reduced StarCoder2's bf16 weights (JAX's `init_params`, layers
    stacked), written by JAX and, as torch tensors in the same tree, by
    the port: the same two files, restored by each package bit for bit."""
    jcfg = jget_config("starcoder2-7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype="bfloat16")

    def to_torch(x):
        a = np.asarray(x)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    tparams = jax.tree.map(to_torch, jparams)
    jckpt.save(str(tmp_path / "j"), 1, jparams)
    checkpoint.save(str(tmp_path / "p"), 1, tparams)
    assert _files(tmp_path / "j" / "1") == _files(tmp_path / "p" / "1")
    like = jax.tree.map(lambda t: torch.zeros_like(t), tparams)
    got, _ = checkpoint.restore(str(tmp_path / "j"), like)
    flat_got = jax.tree.leaves(got)
    assert all(t.dtype == torch.bfloat16 for t in flat_got)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(flat_got, jax.tree.leaves(tparams)))
    jgot, _ = jckpt.restore(str(tmp_path / "p"),
                            jax.tree.map(np.zeros_like, jparams))
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jparams)):
        assert np.array_equal(np.asarray(a).view(np.int16),
                              np.asarray(b).view(np.int16))


def test_port_params_and_optimizer_state_round_trip(tmp_path):
    """The port's own layout (layers a list of dicts) with an AdamW state:
    names by path, bf16 params and fp32 master / moments come back with
    their dtypes and bits."""
    cfg = get_config("starcoder2-7b").reduced()
    jcfg = jget_config("starcoder2-7b").reduced()
    params = params_from_jax(cfg, JM.init_params(
        jcfg, jax.random.PRNGKey(1), dtype="bfloat16"), "cpu")
    ostate = opt.init_adamw(opt.AdamWConfig(), params)
    d = str(tmp_path / "ck")
    checkpoint.save(d, 2, (params, ostate))
    with open(os.path.join(d, "2", "manifest.msgpack"), "rb") as f:
        names = [a["name"] for a in msgpack.unpackb(f.read())["arrays"]]
    assert "0/layers/1/attn/wq" in names and "1/step" in names
    assert names.index("1/m/embed/tok") < names.index("1/master/embed/tok")
    like = (opt.tree_map(torch.zeros_like, params),
            opt.tree_map(torch.zeros_like, ostate))
    (p2, o2), step = checkpoint.restore(d, like)
    assert step == 2
    for a, b in zip(opt.tree_leaves((params, ostate)),
                    opt.tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert M.param_count(cfg) == sum(t.numel() for t in
                                     opt.tree_leaves(p2))
