"""The port's parameter sharding (`repro_torch.sharding`'s placements and
DTensor trees, `models.model.param_axes` / `input_specs`, AdamW's state
axes, the sharded training step, `apply_moe_ep`'s gradients, the kernels'
`local_map` wrappers, `launch.mesh.make_production_mesh`) against the JAX
package, on the CPU.

* Placements and per-rank bytes: every leaf of all 10 archs at full size,
  its params and fp32 AdamW m, v and master, on the pod256 (16 × 16),
  pod512 (2 × 16 × 16) and 2 × 2 meshes, against JAX's `spec_for` over a
  stand-in mesh (no process group).
* `param_axes` (JAX's without the leading "layers" axis), `abstract_adamw`
  and `adamw_state_axes` against JAX's; `kv_heads_of` against the GQA
  rule q head i reads kv head i // n_rep.
* One spawn of 2 × 2 gloo ranks (`tests/_torch_dist.py:sharded_steps`):
  two sharded AdamW steps each of reduced starcoder2-7b (its 4 q heads
  split over "model", its 1 kv head does not), mamba2-780m and olmoe-1b-7b
  at capacity 64, one each of zamba2-2.7b, qwen2-vl-72b and
  whisper-large-v3, from JAX's weights, against JAX's one-device
  `make_train_step`: losses and grad norms at 1e-5 relative, params at
  1e-5 absolute except on at most one entry in 10^4, held to 2 lr (a ~0
  gradient leaves Adam's step sign to rounding, as in
  `tests/test_torch_train.py`). The OLMoE reference is JAX's step with its
  MoE layer in the form of the reference's EP function at a no-drop
  capacity: `apply_moe`'s y (the reference's EP y equals it there) and the
  aux loss averaged over the four ranks' slices (batch halves over
  "data", sequence halves over "model"), as its pmean makes it.
  `apply_moe_ep`'s gradients on whole tensors, summed over the ranks,
  against the same function on one process within 1e-5, and `apply_moe`
  on DTensors (with the expert-buffer `shard` sites) against itself on
  whole tensors;
  `attend` of DTensors against the plain version on whole tensors:
  through `ops.flash_attention` (q heads split and kv heads not, in whole
  groups and one kv head a q head; both split), naive and chunked (banded
  too); `shard`; `make_production_mesh` on 4 ranks.
* ``--mesh pod256|pod512`` raises on one rank; the changed modules import
  neither JAX nor the reference.
"""
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

import _torch_dist
from repro import sharding as jsharding
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, sharding
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.launch.hostdev import spawn_local
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)
MESHES = {"pod256": ((16, 16), ("data", "model")),
          "pod512": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
STACKED = ("layers", "enc_layers")
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=4)
B, S, FRAMES = 4, 32, 64
# family: (arch, AdamW steps); OLMoE at capacity 64 (no drop)
STEPS = {"dense": ("starcoder2-7b", 2), "ssm": ("mamba2-780m", 2),
         "moe": ("olmoe-1b-7b", 2), "hybrid": ("zamba2-2.7b", 1),
         "vlm": ("qwen2-vl-72b", 1), "audio": ("whisper-large-v3", 1)}


def _mesh(shape, names):
    """A DeviceMesh of any shape seen from rank 0, without a process
    group: enough for placements, which read only names and sizes."""
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


class FakeMesh:                     # what the reference's spec_for reads
    def __init__(self, shape):
        self.shape = shape


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts and lists (axes tuples are leaves)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _flat(t, prefix + (i,)).items()}
    return {prefix: tree}


def _leaves(tree) -> list:
    """`_flat`'s leaves in order (a `NamedSharding`, a tuple, is one)."""
    return list(_flat(tree).values())


def _unstack(tree):
    """A stacked (JAX-layout) tree in the port's layout: each of "layers"
    and "enc_layers" a list of per-layer views."""
    out = dict(tree)
    for k in STACKED:
        if k in tree:
            n = opt.tree_leaves(tree[k])[0].shape[0]
            out[k] = [opt.tree_map(lambda t, i=i: t[i], tree[k])
                      for i in range(n)]
    return out


def _jlocal(shape, logical, sizes):
    """The per-rank block of ``shape`` under the reference's spec_for, and
    the spec."""
    spec = tuple(jsharding.spec_for(shape, logical, FakeMesh(sizes)))
    local = list(shape)
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else part or ()):
            local[d] //= sizes[a]
    return local, spec


def _plocal(shape, placements, mesh):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return local


def _nbytes(local, dtype) -> int:
    return int(np.prod(local)) * torch.empty((), dtype=dtype).element_size()


# ======================================================== placements, bytes
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_placements_and_rank_bytes_match_the_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    mesh = _mesh(shape, names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    ocfg, jocfg = opt.AdamWConfig(), jopt.AdamWConfig()
    # the port: its own layout, its placements, its state's
    p_abs = _unstack(M.abstract_params(cfg))
    p_axes = M.param_axes(cfg)
    s_abs = opt.abstract_adamw(ocfg, p_abs)
    s_axes = opt.adamw_state_axes(p_axes)
    got = {"params": sharding.tree_shardings(p_abs, p_axes, mesh),
           "state": sharding.tree_shardings(s_abs, s_axes, mesh)}
    for ns in _leaves(got["params"]):
        assert ns.mesh is mesh
    # the reference: stacked leaves, spec_for over the stand-in mesh
    j_abs, j_axes = JM.abstract_params(jcfg), JM.param_axes(jcfg)
    j_state = jopt.abstract_adamw(jocfg, j_abs)
    j_state_axes = jopt.adamw_state_axes(j_axes)
    is_ax = sharding.is_axes
    jflat = jax.tree_util.tree_flatten_with_path(j_axes, is_leaf=is_ax)[0]
    jabs = dict(jax.tree_util.tree_flatten_with_path(j_abs)[0])
    pflat, aflat = _flat(got["params"]), _flat(p_abs)
    want_bytes = 0
    for path, axes in jflat:
        keys = tuple(k.key for k in path)
        local, spec = _jlocal(jabs[path].shape, axes, sizes)
        want_bytes += _nbytes(local, getattr(torch, str(jabs[path].dtype)))
        stacked = keys[0] in STACKED
        if stacked:                 # "layers" replicates: no mesh dim
            assert axes[0] == "layers" and (not spec or spec[0] is None)
            spec = spec[1:]
        want = tuple(next((Shard(d) for d, part in enumerate(spec)
                           if n == part or (isinstance(part, tuple)
                                            and n in part)), Replicate())
                     for n in names)
        n_layers = jabs[path].shape[0] if stacked else 1
        ports = [keys[:1] + (i,) + keys[1:] for i in range(n_layers)] \
            if stacked else [keys]
        for pk in ports:
            assert pflat[pk].placements == want, (pk, spec)
            assert _plocal(aflat[pk].shape, want, mesh) == \
                (local[1:] if stacked else local)
    assert len(pflat) == sum(jabs[p].shape[0] if p[0].key in STACKED else 1
                             for p, _ in jflat)
    got_bytes = sum(_nbytes(_plocal(t.shape, ns.placements, mesh), t.dtype)
                    for t, ns in zip(opt.tree_leaves(p_abs),
                                     _leaves(got["params"])))
    assert got_bytes == want_bytes
    # the state: fp32 m, v and master in the params' placements
    j_sflat = jax.tree_util.tree_flatten_with_path(j_state_axes,
                                                   is_leaf=is_ax)[0]
    j_sabs = dict(jax.tree_util.tree_flatten_with_path(j_state)[0])
    want_sbytes = sum(_nbytes(_jlocal(j_sabs[p].shape, ax, sizes)[0],
                              getattr(torch, str(j_sabs[p].dtype)))
                      for p, ax in j_sflat)
    got_sbytes = sum(_nbytes(_plocal(t.shape, ns.placements, mesh), t.dtype)
                     for t, ns in zip(opt.tree_leaves(s_abs),
                                      _leaves(got["state"])))
    assert got_sbytes == want_sbytes
    for part in ("m", "v", "master"):
        assert [ns.placements for ns in _leaves(got["state"][part])] \
            == [ns.placements for ns in _leaves(got["params"])]


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_and_adamw_trees_are_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    is_ax = sharding.is_axes
    jflat = {tuple(k.key for k in p): ax for p, ax in
             jax.tree_util.tree_flatten_with_path(JM.param_axes(jcfg),
                                                  is_leaf=is_ax)[0]}
    pflat = _flat(M.param_axes(cfg))
    want = {}
    for keys, ax in jflat.items():
        if keys[0] in STACKED:
            n = getattr(cfg, "n_enc_layers" if keys[0] == "enc_layers"
                        else "n_layers")
            assert ax[0] == "layers"
            want.update({keys[:1] + (i,) + keys[1:]: ax[1:]
                         for i in range(n)})
        else:
            want[keys] = ax
    assert pflat == want
    assert opt.adamw_state_axes(M.param_axes(cfg)) == {
        "step": (), "m": M.param_axes(cfg), "v": M.param_axes(cfg),
        "master": M.param_axes(cfg)}
    assert jopt.adamw_state_axes(JM.param_axes(jcfg))["step"] == ()
    for moment in ("float32", "bfloat16"):
        ocfg = opt.AdamWConfig(moment_dtype=moment)
        got = _flat(opt.abstract_adamw(ocfg, M.abstract_params(cfg)))
        jgot = jax.tree_util.tree_flatten_with_path(jopt.abstract_adamw(
            jopt.AdamWConfig(moment_dtype=moment), JM.abstract_params(jcfg)))
        assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for k, t in got.items()} == \
            {tuple(k.key for k in p): (tuple(s.shape), str(s.dtype))
             for p, s in jgot[0]}
        assert all(t.device.type == "meta" for t in got.values())


@pytest.mark.parametrize("h,kv,m", [(4, 1, 2), (128, 8, 16), (6, 3, 2),
                                    (24, 4, 6), (36, 4, 2), (8, 8, 4),
                                    (16, 2, 4)])
def test_kv_heads_of_follows_the_gqa_rule(h, kv, m):
    """Each rank's q heads against the kv heads it gets: the local kv head
    a local q head reads (i // (h_loc // kv_loc) in a slice, i in a list)
    is global kv head (block·h_loc + i) // n_rep."""
    n_rep, h_loc = h // kv, h // m
    for block in range(m):
        heads = ops.kv_heads_of(block, h_loc, n_rep)
        ids = list(range(kv))[heads] if isinstance(heads, slice) else heads
        assert h_loc % len(ids) == 0
        for i in range(h_loc):
            assert ids[i // (h_loc // len(ids))] == \
                (block * h_loc + i) // n_rep


def test_reduced_starcoder2_splits_q_heads_and_not_kv_heads():
    cfg = get_config("starcoder2-7b").reduced()
    mesh = _mesh((2, 2), ("data", "model"))
    axes = M.param_axes(cfg)["layers"][0]["attn"]
    q = sharding.named_sharding((cfg.d_model, cfg.n_heads, cfg.head_dim),
                                axes["wq"], mesh)
    k = sharding.named_sharding((cfg.d_model, cfg.n_kv_heads, cfg.head_dim),
                                axes["wk"], mesh)
    assert q.placements[1] == Shard(1) and k.placements[1] == Replicate()
    act = ("batch", "seq", "heads", None)
    assert sharding.placements(sharding.spec_for(
        (B, S, cfg.n_heads, cfg.head_dim), act, mesh), mesh) == \
        (Shard(0), Shard(2))


def test_shard_without_a_mesh_or_on_a_plain_tensor_is_a_no_op():
    x = torch.ones(4, 4)
    assert sharding.shard(x, "batch", None) is x
    with sharding.use_mesh(_mesh((2, 2), ("data", "model"))):
        assert sharding.shard(x, "batch", None) is x
    assert sharding.replicate_like(x, x) is x
    assert sharding.place_like(x, x, ("batch", None)) is x


def test_production_meshes_raise_on_one_rank():
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"a mesh of {n} ranks needs "
                           f"a process group of {n} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod)
    for name, n in (("pod256", 256), ("pod512", 512)):
        with pytest.raises(RuntimeError, match=f"process group of {n}"):
            train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "1",
                        "--mesh", name], device="cpu")


# ============================================================ the 2 × 2 spawn
def _batch(cfg, seed):
    """A training batch as numpy arrays (`tests/test_torch_train.py`'s
    layout): tokens and labels of S, a mask with row 0's last 5 labels
    off, a VLM's S / 8 patch embeddings, an audio model's FRAMES frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mask = np.ones((B, S), np.float32)
    mask[0, -5:] = 0.0
    out["mask"] = mask
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (B, S // 8, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal(
            (B, FRAMES, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jax_ep_moe(cfg, p, x):
    """The reference's EP function on one device at a no-drop capacity over
    the 2 × 2 mesh: `apply_moe`'s y and the aux of each rank's slice (batch
    half over "data", sequence half over "model"), averaged."""
    y, _ = jmoe.apply_moe(cfg, p, x)
    b, s, _ = x.shape
    parts = []
    for bi in range(2):
        for si in range(2):
            xs = x[bi * b // 2:(bi + 1) * b // 2,
                   si * s // 2:(si + 1) * s // 2]
            _, idx, probs = jmoe.route(cfg, p, xs)
            parts.append(jmoe.load_balance_loss(cfg, probs, idx))
    return y, sum(parts) / 4


def _moe_ep_reference(cfg, p, x, w):
    """`_jax_ep_moe`'s function in the port, on one process: (y, aux, the
    gradients of (y · w).sum() + aux as x, router, wi_gate, wi_up, wo)."""
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, _ = moe.apply_moe(cfg, p, x)
    b, s, _ = x.shape
    parts = []
    for bi in range(2):
        for si in range(2):
            xs = x[bi * b // 2:(bi + 1) * b // 2,
                   si * s // 2:(si + 1) * s // 2]
            _, idx, probs = moe.route(cfg, p, xs)
            parts.append(moe.load_balance_loss(cfg, probs, idx))
    aux = sum(parts) / 4
    grads = torch.autograd.grad((y * w).sum() + aux, [x, *p.values()])
    return (y.detach().numpy(), float(aux.detach()),
            [g.numpy() for g in grads])


# (q shape, kv heads, causal, impl, window): "auto" is `ops.flash_attention`
# on shards (its plain version on the CPU): q heads split, kv not, in whole
# groups and one kv head a q head; both split. Then the plain routes on
# DTensors (on the 1-D "model" mesh): naive, chunked (one kv chunk),
# chunked banded (a window).
ATTN = [((4, 8, 4, 16), 1, True, "auto", None),
        ((4, 8, 6, 16), 3, False, "auto", None),
        ((4, 8, 4, 16), 2, True, "auto", None),
        ((4, 8, 4, 16), 1, True, "naive", 5),
        ((2, 1024, 4, 16), 1, True, "chunked", None),
        ((2, 1024, 4, 16), 1, True, "chunked", 300)]


def _jax_steps(family, jcfg, jparams, batches):
    """JAX's one-device `make_train_step` over ``batches``: the metrics and
    the final params in the port's layout."""
    with pytest.MonkeyPatch.context() as mp:
        if family == "moe":
            mp.setattr(jmoe, "apply_moe_auto", _jax_ep_moe)
        jstep = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(
            **ADAMW), remat=False))
        jst = jopt.init_adamw(jopt.AdamWConfig(**ADAMW), jparams)
        jp, metrics = jparams, []
        for batch in batches:
            jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            metrics.append({k: float(jm[k]) for k in ("loss",
                                                      "grad_norm")})
    return metrics, [t.numpy() for t in opt.tree_leaves(
        convert.tree_from_jax(jax.tree.map(np.asarray, jp), "cpu"))]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """One spawn of 2 × 2 gloo ranks, and JAX's one-device steps beside it
    (in this process while the ranks run)."""
    steps, refs = [], []
    for family, (arch, n) in STEPS.items():
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        cf = 64.0 if family == "moe" else None
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        params = convert.params_from_jax(cfg, jax.tree.map(np.asarray,
                                                           jparams),
                                         device="cpu")
        batches = [_batch(cfg, 20 + i) for i in range(n)]
        refs.append((family, jcfg, jparams, batches))
        steps.append((arch, cf, params, ADAMW, batches))
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              capacity_factor=64.0)
    gen = torch.Generator().manual_seed(3)
    mp_ = {k: torch.randn(s.shape, generator=gen) * 0.02
           for k, s in moe.moe_schema(cfg).items()}
    x = torch.randn((B, 8, cfg.d_model), generator=gen)
    w = torch.randn((B, 8, cfg.d_model), generator=gen)
    attn = []
    for qs, kv, causal, impl, window in ATTN:
        q = torch.randn(qs, generator=gen)
        k, v = (torch.randn(qs[:2] + (kv, qs[3]), generator=gen)
                for _ in range(2))
        attn.append((q, k, v, causal, impl, window))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_local, 4, _torch_dist.sharded_steps, steps,
                            (mp_, x, w), attn, timeout=180)
        want = {ref[0]: _jax_steps(*ref) for ref in refs}
        return {"ranks": ranks.result(), "want": want,
                "moe": (cfg, mp_, x, w), "attn": attn}


@pytest.mark.parametrize("family", list(STEPS))
def test_sharded_train_step_matches_the_reference(sharded, family):
    metrics, want = sharded["want"][family]
    ranks = [r["steps"][list(STEPS).index(family)] for r in sharded["ranks"]]
    for got in ranks:
        assert got["arch"] == STEPS[family][0]
        assert got["dtensor"] and got["state_placed"]
        for i, m in enumerate(metrics):
            np.testing.assert_allclose(got["losses"][i], m["loss"],
                                       rtol=1e-5, err_msg=f"loss {i}")
            np.testing.assert_allclose(got["grad_norms"][i], m["grad_norm"],
                                       rtol=1e-5, err_msg=f"norm {i}")
        diff = np.concatenate([np.abs(p - w).ravel()
                               for p, w in zip(got["params"], want)])
        assert diff.max() <= 2 * ADAMW["lr"]
        assert (diff > 1e-5).mean() <= 1e-4, (diff > 1e-5).sum()
    # every rank holds the same whole params
    for got in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["params"], ranks[0]["params"]))


def test_apply_moe_ep_gradients_match_one_process(sharded):
    cfg, p, x, w = sharded["moe"]
    y, aux, want = _moe_ep_reference(cfg, p, x, w)
    ranks = [r["moe"] for r in sharded["ranks"]]
    for y_r, aux_r, _ in ranks:
        np.testing.assert_allclose(y_r, y, atol=1e-5, rtol=0)
        assert abs(aux_r - aux) <= 1e-6
    for i, g in enumerate(want):       # x, router, wi_gate, wi_up, wo
        got = sum(r[2][i] for r in ranks)
        np.testing.assert_allclose(got, g, atol=1e-5, rtol=0, err_msg=str(i))
        assert np.abs(g).max() > 0


def test_apply_moe_on_dtensors_matches_the_plain_layer(sharded):
    cfg, p, x, w = sharded["moe"]
    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, aux = moe.apply_moe(cfg, ps, xs)
    want = torch.autograd.grad((y * w).sum() + aux, [xs, *ps.values()])
    for r in sharded["ranks"]:
        y_r, aux_r, grads = r["moe_dtensor"]
        np.testing.assert_allclose(y_r, y.detach().numpy(), atol=1e-5,
                                   rtol=0)
        assert abs(aux_r - aux.item()) <= 1e-6
        for g, g_want in zip(grads, want):
            np.testing.assert_allclose(g, g_want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", range(len(ATTN)))
def test_attention_on_shards_matches_the_plain_version(sharded, case):
    q, k, v, causal, impl, window = sharded["attn"][case]
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = (fa.flash_attention_plain(*xs, causal=causal, window=window)
         if impl == "auto" else
         attention.attend(*xs, causal=causal, window=window, impl=impl))
    want = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        (o * q).sum(), xs)]
    split_kv = k.shape[2] % 2 == 0
    for r in sharded["ranks"]:
        got = r["attn"][case]
        for a, b in zip(got[:4], want):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        if impl == "auto":
            assert got[4] == ["S(0)", "S(2)"]
            assert got[5] == ["S(0)", "S(2)" if split_kv else "R"]
        else:
            assert got[4] == ["S(2)"]


def test_shard_redistributes_and_production_mesh_checks_the_group(sharded):
    for r in sharded["ranks"]:
        plain_same, dt_same, placements, whole, local = r["shard"]
        assert plain_same and dt_same       # no mesh current: unchanged
        assert placements == ["S(0)", "R"]
        assert whole == np.arange(16.0).reshape(4, 4).tolist()
        block = (r["rank"] // 2) * 2        # this rank's data index
        assert local == np.arange(16.0).reshape(4, 4)[block:block + 2
                                                      ].tolist()
        assert r["production"] == "a mesh of 256 ranks on a process group " \
            "of 4"


def test_changed_modules_load_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.sharding, repro_torch.models.model, "
            "repro_torch.models.attention, repro_torch.models.blocks, "
            "repro_torch.models.layers, repro_torch.models.rope, "
            "repro_torch.models.moe, repro_torch.kernels.ops, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.launch.mesh, repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
