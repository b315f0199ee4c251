"""The port's audio family (Whisper: a bidirectional encoder over stub frame
embeddings and a decoder with self- and cross-attention) against the JAX
package, on the CPU, with JAX's own weights carried across by
`convert.params_from_jax`.

The reduced Whisper (2 + 2 layers, d_model 256, 4 / 4 heads of 64,
LayerNorm, GELU) over 64 frames, as JAX's own tests give it
(`tests/test_engine.py`), drawn with numpy from a seed. In float32 the two
frameworks differ only in the order of their sums, so encoder output, cross
caches, logits and caches are held at atol = rtol = 2e-5
(`tests/test_torch_model.py`'s TOL); a decode step after prefill against
`forward` over the extended sequence at 2e-3, that file's tolerance for
the same check. The decode step's cross-attention runs the plain
`decode_attention` at pos T - 1 on every row, against JAX's unmasked
einsum. The sinusoid is held to one float32 ulp of 1.0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import model as M

torch.set_num_threads(1)
ARCH = "whisper-large-v3"
TOL = dict(atol=2e-5, rtol=2e-5)
ULP = dict(atol=2.0 ** -23, rtol=0)
B, S, FRAMES, MAX_LEN = 2, 12, 64, 32


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced Whisper."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def frames(cfg, seed, b=B, n=FRAMES):
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model), dtype=np.float32)


def inputs_pair(cfg, toks, seed):
    f = frames(cfg, seed)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)},
            {"tokens": toks, "frames": f})


def numel(tree):
    """Elements of every tensor in nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def close_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], tol)
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            close(got[k], want[k], tol)


@pytest.mark.parametrize("seq,d,offset", [(FRAMES, 256, 0), (448, 1280, 0),
                                          (1500, 1280, 0), (10, 1280, 1490)])
def test_sinusoid_matches_reference(seq, d, offset):
    """Whisper's encoder (1,500 frames) and decoder (448) tables at full
    width, at an offset, and the reduced width."""
    got = M.sinusoid(seq, d, offset, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    close(got, JM.sinusoid(seq, d, offset), ULP)


def test_per_row_decode_sinusoid_matches_reference():
    """`decode_step`'s per-row table, as JAX's forms it from a (B,) pos."""
    d = 1280
    pos = np.array([0, 5, 447, 1499, 3], np.int32)
    i = jnp.arange(d // 2)[None, :]
    ang = jnp.asarray(pos)[:, None] / jnp.power(10_000.0, 2 * i / d)
    want = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
    close(M.sinusoid_at(torch.tensor(pos), d), want, ULP)


def test_param_count_and_tree_match_reference(pair):
    """Whisper-large-v3 at full width (32 + 32 layers), and `init_params`'
    tree against JAX's, leaf by leaf."""
    assert M.param_count(get_config(ARCH)) == \
        JM.param_count(jget_config(ARCH)) == 1_601_976_320
    jcfg, jparams, cfg, _ = pair
    params = M.init_params(cfg, seed=3, device="cpu")
    assert set(params) == set(jparams) == {"embed", "enc_layers", "enc_lnf",
                                           "layers", "lnf"}
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    assert set(params["layers"][0]) == {"ln1", "self", "ln2", "cross", "ln3",
                                        "mlp"}
    for name in ("enc_layers", "layers"):
        for k, want in jax.tree_util.tree_leaves_with_path(jparams[name]):
            got = params[name][1]
            for key in k:
                got = got[key.key]
            assert tuple(got.shape) == tuple(want.shape[1:]), (name, k)
    assert numel(params) == M.param_count(cfg)


def test_encode_audio_and_cross_caches_match_reference(pair):
    jcfg, jparams, cfg, params = pair
    f = frames(cfg, seed=1)
    jenc = JM.encode_audio(jcfg, jparams, jnp.asarray(f))
    enc = M.encode_audio(cfg, params, f, device="cpu")
    close(enc, jenc)
    jcross = JM.fill_cross_caches(jcfg, jparams, jenc)
    cross = M.fill_cross_caches(cfg, params, torch.tensor(np.asarray(jenc)))
    close_tree(cross, jcross)


def test_forward_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=2), seed=3)
    want, _ = JM.forward(jcfg, jparams, jin)
    got, aux = M.forward(cfg, params, tin, device="cpu")
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    close(got, want)


def test_prefill_matches_reference_logits_and_both_caches(pair):
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=4), seed=5)
    jlast, jcache = JM.prefill(jcfg, jparams, jin, MAX_LEN)
    last, cache = M.prefill(cfg, params, tin, MAX_LEN, device="cpu")
    close(last, jlast)
    assert cache["cross"]["k"].shape[2] == FRAMES
    close_tree(cache, jcache)


@pytest.mark.parametrize("pos", [S, [S, 5]])
def test_decode_step_matches_reference(pair, pos):
    """At one pos for every row and at per-row pos (the slot layout): the
    self cache written at pos, the cross cache read whole and unchanged."""
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=6), seed=7)
    _, jcache = JM.prefill(jcfg, jparams, jin, MAX_LEN)
    _, cache = M.prefill(cfg, params, tin, MAX_LEN, device="cpu")
    cross_before = {k: v.clone() for k, v in cache["cross"].items()}
    nxt = tokens(cfg, (B, 1), seed=8)
    pos = np.array(pos, np.int32)
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                 jnp.asarray(pos))
    lg, cache = M.decode_step(cfg, params, nxt, cache, torch.tensor(pos),
                              device="cpu")
    close(lg, jlg)
    close_tree(cache, jcache)
    for k, v in cross_before.items():
        assert torch.equal(cache["cross"][k], v)


def test_prefill_then_decode_matches_forward(pair):
    """The port against itself: prefill, then 4 teacher-forced decode steps
    against `forward` over the extended sequence, the frames the same."""
    _, _, cfg, params = pair
    toks = tokens(cfg, (B, S + 4), seed=9)
    f = frames(cfg, seed=10)
    full, _ = M.forward(cfg, params, {"tokens": toks, "frames": f},
                        device="cpu")
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :S], "frames": f},
                            MAX_LEN, device="cpu")
    close(last, full[:, S - 1])
    for i in range(S, S + 4):
        lg, cache = M.decode_step(cfg, params, toks[:, i:i + 1], cache, i,
                                  device="cpu")
        close(lg[:, 0], full[:, i], dict(atol=2e-3, rtol=2e-3))


def test_init_decode_caches_match_reference_shapes(pair):
    """{"self", "cross"}, the cross cache at Whisper's 1,500 frames."""
    jcfg, _, cfg, _ = pair
    jcache, _ = JM.init_decode_caches(jcfg, 3, 40, jnp.float32,
                                      abstract=True)
    cache = M.init_decode_caches(cfg, 3, 40, torch.float32, device="cpu")
    assert set(cache) == set(jcache) == {"self", "cross"}
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(cache[part][k].shape) == \
                tuple(jcache[part][k].shape), (part, k)
    assert cache["cross"]["k"].shape[2] == M.WHISPER_ENC_FRAMES == 1500
