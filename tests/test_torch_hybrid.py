"""The port's hybrid family (Zamba2: a Mamba2 backbone with one
weight-shared dense block every `shared_attn_period` layers) against the
JAX package, on the CPU, with JAX's own weights carried across by
`convert.params_from_jax`.

The reduced Zamba2 at 4 layers, so that its period of 2 gives two groups,
each with its own shared-attention cache (window 64, head_dim 64, n_rep 1,
SSD chunk 32). Prompts are multiples of the chunk. In float32 the two
frameworks differ only in the order of their sums, so logits and caches
are held at atol = rtol = 2e-5 (`tests/test_torch_model.py`'s TOL); decode
steps against `forward` over the extended sequence at 2e-3, that file's
tolerance for the same check. On the CPU the shared block's prefill runs
`_attend_naive`, its decode the plain `decode_attention`, and the SSD core
the plain `ssd_chunk`.
"""
import dataclasses

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
ARCH = "zamba2-2.7b"
TOL = dict(atol=2e-5, rtol=2e-5)
B = 2


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params): the reduced Zamba2 at
    4 layers (two groups of 2)."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), n_layers=4)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=4)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def close_cache(cache, jcache):
    """Both caches of the hybrid family: "ssm" (conv, state) per layer and
    "shared_attn" (k, v) per group."""
    assert set(cache) == set(jcache) == {"ssm", "shared_attn"}
    for path, want in leaves(jcache):
        got = at(cache, path)
        assert tuple(got.shape) == tuple(want.shape), path
        close(got, want)


def test_param_count_and_tree_match_reference(pair):
    """The schema (54 SSM layers + one shared dense block at full width),
    and `init_params`' tree against JAX's, leaf by leaf."""
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert M.param_count(full) == JM.param_count(jfull) == 2_422_670_240
    jcfg, jparams, cfg, _ = pair
    assert M.param_count(cfg) == JM.param_count(jcfg)
    params = M.init_params(cfg, seed=3, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    assert set(params) == set(jparams) == {"embed", "layers", "shared", "lnf"}
    for path, leaf in leaves(jparams):
        if path[0] == "layers":
            got, shape = at(params["layers"][1], path[1:]), leaf.shape[1:]
        else:
            got, shape = at(params, path), leaf.shape
        assert tuple(got.shape) == tuple(shape), path
        assert got.dtype == torch.float32, path
    n = sum(x.numel() for _, x in leaves({k: v for k, v in params.items()
                                          if k != "layers"}))
    n += sum(x.numel() for layer in params["layers"] for _, x in leaves(layer))
    assert n == M.param_count(cfg)


def test_params_from_jax_carries_every_leaf(pair):
    _, jparams, cfg, params = pair
    for path, leaf in leaves(jparams):
        leaf = np.asarray(leaf)
        if path[0] == "layers":
            for i in range(cfg.n_layers):
                np.testing.assert_array_equal(
                    at(params["layers"][i], path[1:]).numpy(), leaf[i])
        else:
            np.testing.assert_array_equal(at(params, path).numpy(), leaf)


def test_forward_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, 96), seed=1)         # past the window of 64
    want, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    assert got.shape == (B, 96, cfg.vocab) and float(aux) == 0.0
    close(got, want)


@pytest.mark.parametrize("s,max_len", [(32, 128), (96, 128)])
def test_prefill_matches_reference_logits_and_both_caches(pair, s, max_len):
    """A prompt shorter than the ring (T = min(max_len, 64) = 64) and one
    longer, whose ring keeps its last 64 tokens."""
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, s), seed=2)
    jlast, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               max_len)
    last, cache = M.prefill(cfg, params, {"tokens": toks}, max_len,
                            device="cpu")
    close(last, jlast)
    assert cache["shared_attn"]["k"].shape[0] == 2       # one per group
    close_cache(cache, jcache)


@pytest.mark.parametrize("s,pos", [(32, [32, 20]), (64, [64, 63]),
                                   (64, [100, 200])])
def test_decode_step_matches_reference_at_per_row_pos(pair, s, pos):
    """Per-row pos before the ring wraps (< T), at T - 1 and at T, and far
    past it (the shared block's ring slot pos % T)."""
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, s), seed=3)
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 128)
    _, cache = M.prefill(cfg, params, {"tokens": toks}, 128, device="cpu")
    nxt = tokens(cfg, (B, 1), seed=4)
    pos = np.array(pos, np.int32)
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                 jnp.asarray(pos))
    lg, cache = M.decode_step(cfg, params, nxt, cache, torch.tensor(pos),
                              device="cpu")
    close(lg, jlg)
    close_cache(cache, jcache)


def test_prefill_then_decode_matches_forward(pair):
    """The port against itself: a 64-token prefill fills the 64-slot ring,
    then 32 teacher-forced decode steps (every one past the ring's end)
    against `forward` over all 96 tokens (a multiple of the SSD chunk)."""
    _, _, cfg, params = pair
    toks = tokens(cfg, (B, 96), seed=5)
    full, _ = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :64]}, 128,
                            device="cpu")
    close(last, full[:, 63])
    for i in range(64, 96):
        lg, cache = M.decode_step(cfg, params, toks[:, i:i + 1], cache, i,
                                  device="cpu")
        close(lg[:, 0], full[:, i], dict(atol=2e-3, rtol=2e-3))


def test_hybrid_needs_whole_groups():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=3)
    with pytest.raises(ValueError, match="shared_attn_period"):
        M.param_count(cfg)
