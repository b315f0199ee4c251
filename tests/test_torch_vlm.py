"""The port's VLM family (Qwen2-VL: a dense decoder with M-RoPE and a
projection of stub patch embeddings ahead of the text) against the JAX
package, on the CPU, with JAX's own weights carried across by
`convert.params_from_jax`.

`apply_mrope` is held against JAX's with distinct (temporal, height,
width) ids drawn with numpy: in float32 at 1e-6 (both form the same fp32
angles; cos, sin and the rotation may round differently), in bfloat16 at
one bf16 ulp of the largest value. The reduced Qwen2-VL (2 layers,
d_model 256, 4 heads over 1 KV head of 64, qkv bias, RMSNorm, SwiGLU) with
random patch embeddings: logits and caches at atol = rtol = 2e-5
(`tests/test_torch_model.py`'s TOL); a decode step after prefill against
`forward` over the extended sequence at 2e-3, that file's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import rope as jrope
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.models import rope

torch.set_num_threads(1)
ARCH = "qwen2-vl-72b"
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, MAX_LEN = 2, 16, 48


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params) of the reduced
    Qwen2-VL."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, cfg, params


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(
        np.int32)


def vision(cfg, s, seed, b=B):
    """Patch embeddings for a prompt of ``s`` tokens: 1/8 of its length."""
    n = max(s // M.VLM_VISION_FRACTION, 1)
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model), dtype=np.float32)


def inputs_pair(cfg, toks, seed):
    v = vision(cfg, toks.shape[1], seed, toks.shape[0])
    return ({"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(v)},
            {"tokens": toks, "vision_embeds": v})


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("head_dim", [64, 80, 120, 128])
def test_mrope_sections_match_reference(head_dim):
    got = rope.mrope_sections(head_dim)
    assert got == jrope.mrope_sections(head_dim)
    assert sum(got) == head_dim // 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_apply_mrope_matches_reference(dtype, head_dim):
    """Distinct (t, h, w) ids, as a patch grid gives them."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 24, 3, head_dim), dtype=np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 24)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = jrope.apply_mrope(jx, jnp.asarray(pos3), 1e6)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = rope.apply_mrope(tx, torch.tensor(pos3), 1e6)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        close(got.float(), as_np(want), dict(atol=1e-6, rtol=0))
    else:
        # one bf16 ulp (2^-7 of the binade) of the largest output value
        ulp = 2.0 ** (np.floor(np.log2(np.abs(as_np(want)).max())) - 7)
        close(got.float(), as_np(want), dict(atol=ulp, rtol=0))


def test_text_only_mrope_is_rope():
    """With one id per token (t = h = w), `positional` gives RoPE's bits."""
    cfg = get_config(ARCH).reduced()
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 20, 4, cfg.head_dim), dtype=np.float32))
    pos = torch.arange(20, dtype=torch.int32)[None].expand(2, 20) * 37
    got = rope.positional(cfg, pos)(x)
    assert torch.equal(got, rope.apply_rope(x, pos, cfg.rope_theta))


def test_param_count_and_tree_match_reference(pair):
    assert M.param_count(get_config(ARCH)) == \
        JM.param_count(jget_config(ARCH)) == 72_773_312_512
    jcfg, jparams, cfg, params = pair
    assert M.param_count(cfg) == JM.param_count(jcfg)
    fresh = M.init_params(cfg, seed=3, device="cpu")
    assert set(fresh) == set(jparams) == {"embed", "layers", "vision_proj",
                                          "lnf"}
    assert tuple(fresh["vision_proj"]["w"].shape) == \
        tuple(jparams["vision_proj"]["w"].shape)
    np.testing.assert_array_equal(params["vision_proj"]["w"].numpy(),
                                  np.asarray(jparams["vision_proj"]["w"]))


def test_forward_with_vision_matches_reference(pair):
    """Logits over the vision prefix and the text."""
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=2), seed=3)
    want, _ = JM.forward(jcfg, jparams, jin)
    got, aux = M.forward(cfg, params, tin, device="cpu")
    assert got.shape == (B, M.prefill_len(cfg, S), cfg.vocab)
    assert float(aux) == 0.0
    close(got, want)


def test_prefill_matches_reference_logits_and_cache(pair):
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=4), seed=5)
    jlast, jcache = JM.prefill(jcfg, jparams, jin, MAX_LEN)
    last, cache = M.prefill(cfg, params, tin, MAX_LEN, device="cpu")
    close(last, jlast)
    assert set(cache) == set(jcache) == {"attn"}
    for k in ("k", "v"):
        assert tuple(cache["attn"][k].shape) == tuple(jcache["attn"][k].shape)
        close(cache["attn"][k], jcache["attn"][k])


def test_decode_step_at_prefill_len_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    jin, tin = inputs_pair(cfg, tokens(cfg, (B, S), seed=6), seed=7)
    _, jcache = JM.prefill(jcfg, jparams, jin, MAX_LEN)
    _, cache = M.prefill(cfg, params, tin, MAX_LEN, device="cpu")
    nxt = tokens(cfg, (B, 1), seed=8)
    pos = M.prefill_len(cfg, S)
    jlg, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                 jnp.int32(pos))
    lg, cache = M.decode_step(cfg, params, nxt, cache, pos, device="cpu")
    close(lg, jlg)
    for k in ("k", "v"):
        close(cache["attn"][k], jcache["attn"][k])


def test_prefill_then_decode_matches_forward(pair):
    """The port against itself: a decode step at `prefill_len` against
    `forward` over the extended text, the patch embeddings the same."""
    _, _, cfg, params = pair
    toks = tokens(cfg, (B, S + 1), seed=9)
    v = vision(cfg, S, seed=10)
    full, _ = M.forward(cfg, params, {"tokens": toks, "vision_embeds": v},
                        device="cpu")
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :S],
                                          "vision_embeds": v}, MAX_LEN,
                            device="cpu")
    close(last, full[:, -2])
    lg, _ = M.decode_step(cfg, params, toks[:, S:], cache,
                          M.prefill_len(cfg, S), device="cpu")
    close(lg[:, 0], full[:, -1], dict(atol=2e-3, rtol=2e-3))
