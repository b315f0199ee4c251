"""The port's dense model (`repro_torch.models`) against the JAX package, on
the CPU, with JAX's own weights carried across by `convert.params_from_jax`.

Two reduced dense configurations: StarCoder2 (LayerNorm, GELU-tanh MLP
with biases, qkv bias; H 4 over KV 1, so n_rep 4) and Llama 3 (RMSNorm,
SwiGLU, θ = 5e5); two reduced MoE ones: OLMoE (4 experts, top 2, n_rep 1)
and Arctic (the same with a dense residual MLP, n_rep 4), at the configs'
capacity factor, so their prefills may drop entries as JAX's do, and with
`forward`'s load-balance loss held at 1e-6; and H2O-Danube's sliding window
with a ring cache shorter than the prompt, for the decode path that keeps
the plain einsum.
In float32 the two frameworks differ only in the order of
their sums (matmuls, softmax, norms), so logits and caches are held at
atol = rtol = 2e-5, the tolerance `tests/test_engine.py` holds prefill to;
one decode step after prefill against `forward` on the extended sequence at
2e-3, that test's own tolerance for the same check (for MoE at the no-drop
capacity 64 that test uses: `forward` over S + 1 tokens has another
capacity than a prefill over S).
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
from repro_torch.configs.base import get_config, list_archs
from repro_torch.models import model as M

torch.set_num_threads(1)
ARCHS = ["starcoder2-7b", "llama3-405b", "olmoe-1b-7b", "arctic-480b"]
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, MAX_LEN = 2, 12, 32


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, JAX params, port cfg, port params) on the reduced config."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def test_param_count_of_starcoder2_7b():
    cfg = get_config("starcoder2-7b")
    assert M.param_count(cfg) == cfg.param_count() == 7_400_268_800
    assert M.param_count(cfg) == JM.param_count(jget_config("starcoder2-7b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """At the published widths, all parameters and the experts' alone."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for experts_only in (False, True):
        assert M.param_count(cfg, experts_only) == \
            JM.param_count(jcfg, experts_only)
    assert (M.param_count(cfg, experts_only=True) > 0) == \
        (cfg.family == "moe")


def test_configs_are_the_reference_configs():
    from repro.configs.base import list_archs as jlist_archs
    assert list_archs() == jlist_archs()
    for name in list_archs():
        assert get_config(name).__dict__ == jget_config(name).__dict__
        assert get_config(name).reduced().__dict__ == \
            jget_config(name).reduced().__dict__


def test_init_params_has_the_reference_tree(pair):
    jcfg, jparams, cfg, _ = pair
    params = M.init_params(cfg, seed=3, device="cpu")
    again = M.init_params(cfg, seed=3, device="cpu")
    assert len(params["layers"]) == cfg.n_layers

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, tree

    for path, leaf in leaves(jparams):
        if path[0] == "layers":
            got = params["layers"][1]
            for k in path[1:]:
                got = got[k]
            want_shape = leaf.shape[1:]
        else:
            got = params
            for k in path:
                got = got[k]
            want_shape = leaf.shape
        assert tuple(got.shape) == tuple(want_shape), path
        assert got.dtype == torch.float32, path
    assert torch.equal(params["layers"][1]["attn"]["wq"],
                       again["layers"][1]["attn"]["wq"])
    ffn = params["layers"][0].get("mlp") or params["layers"][0]["moe"]
    std = ffn["wi" if "wi" in ffn else "wi_up"].std().item()
    assert abs(std - 0.02) < 0.002


def test_forward_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, S), seed=1)
    want, jaux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    assert got.shape == (B, S, cfg.vocab) and aux.dtype == torch.float32
    close(got, want)
    if cfg.family == "moe":
        close(aux, jaux, dict(atol=1e-6, rtol=0))
    else:
        assert float(aux) == 0.0


def test_prefill_matches_reference_logits_and_cache(pair):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, S), seed=2)
    jlast, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               MAX_LEN)
    last, cache = M.prefill(cfg, params, {"tokens": toks}, MAX_LEN,
                            device="cpu")
    close(last, jlast)
    for name in ("k", "v"):
        assert tuple(cache["attn"][name].shape) == \
            jcache["attn"][name].shape
        close(cache["attn"][name], jcache["attn"][name])


def test_decode_step_matches_reference_at_per_row_pos(pair):
    jcfg, jparams, cfg, params = pair
    toks = tokens(cfg, (B, S), seed=3)
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           MAX_LEN)
    _, cache = M.prefill(cfg, params, {"tokens": toks}, MAX_LEN,
                         device="cpu")
    nxt = tokens(cfg, (B, 1), seed=4)
    pos = np.array([S, S - 4], np.int32)       # each row at its own slot
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                 jnp.asarray(pos))
    lg, cache = M.decode_step(cfg, params, nxt, cache, torch.tensor(pos),
                              device="cpu")
    close(lg, jlg)
    for name in ("k", "v"):
        close(cache["attn"][name], jcache["attn"][name])


def test_prefill_then_decode_matches_forward(pair):
    """The port against itself: its decode cache continues its prompt
    (`tests/test_engine.py::test_prefill_matches_forward`'s check)."""
    _, _, cfg, params = pair
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)   # no drops
    toks = tokens(cfg, (B, S), seed=5)
    full, _ = M.forward(cfg, params, {"tokens": toks}, device="cpu")
    last, cache = M.prefill(cfg, params, {"tokens": toks}, MAX_LEN,
                            device="cpu")
    close(last, full[:, -1])
    nxt = last.argmax(-1)[:, None]
    lg2, _ = M.decode_step(cfg, params, nxt, cache, M.prefill_len(cfg, S),
                           device="cpu")
    ext = np.concatenate([toks, nxt.numpy().astype(np.int32)], axis=1)
    full2, _ = M.forward(cfg, params, {"tokens": ext}, device="cpu")
    close(lg2[:, 0], full2[:, -1], dict(atol=2e-3, rtol=2e-3))


@pytest.mark.parametrize("arch,item", [
    ("zamba2-2.7b", "A23"),
    ("qwen2-vl-72b", "A24"), ("whisper-large-v3", "A25")])
def test_other_families_raise_naming_their_item(arch, item):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=item):
        M.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        M.param_count(cfg)


def test_apply_moe_ep_raises_naming_a18():
    """Expert parallelism waits for the port's mesh (A18)."""
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b").reduced()
    with pytest.raises(NotImplementedError, match="A18"):
        moe.apply_moe_ep(cfg, {}, torch.zeros((1, 2, cfg.d_model)),
                         mesh=None, batch_axes=("data",))


def test_sliding_window_ring_cache_matches_reference():
    """A sliding-window dense config (H2O-Danube, window 64 reduced) with a
    cache shorter than the prompt: prefill keeps the last T tokens in the
    ring, and decode (the plain einsum with the ring mask, not the kernel)
    matches JAX at per-row positions past the ring's end."""
    jcfg = jget_config("h2o-danube-3-4b").reduced()
    cfg = get_config("h2o-danube-3-4b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    s, max_len = 40, 32
    toks = tokens(cfg, (B, s), seed=6)
    jlast, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               max_len)
    last, cache = M.prefill(cfg, params, {"tokens": toks}, max_len,
                            device="cpu")
    close(last, jlast)
    nxt = tokens(cfg, (B, 1), seed=7)
    pos = np.array([s, s - 2], np.int32)
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                 jnp.asarray(pos))
    lg, cache = M.decode_step(cfg, params, nxt, cache, torch.tensor(pos),
                              device="cpu")
    close(lg, jlg)
    for name in ("k", "v"):
        close(cache["attn"][name], jcache["attn"][name])
