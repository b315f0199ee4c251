"""Sliding-window decode (a ring cache) against the JAX package, on the CPU.

`models.attention.apply_attention_decode` with a window writes the new
token at slot pos % T of a T-slot ring and attends through
`ops.decode_attention` with the raw pos, which on the CPU is the kernel's
plain version. JAX keeps its ring mask, age < min(pos + 1, T) with age =
(pos % T - slot) % T. The two select the same slots at every pos: the
slots <= pos while pos < T, and all T from then on. The reduced
H2O-Danube-3-4B's attention (4 / 1 heads of 64, window 64) and Zamba2's
shared block (4 / 4 heads) are held at pos < T, T - 1, T and far past T,
scalar and per row, on a cache of random numbers in every slot (so a slot
read that should not be shows), at atol = rtol = 2e-5: the sums are the
same but taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
B, T = 4, 64


@pytest.fixture(scope="module", params=["h2o-danube-3-4b", "zamba2-2.7b"])
def layer(request):
    """(JAX cfg, JAX attention params, port cfg, port attention params)."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(2))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    if cfg.family == "hybrid":
        return jcfg, jparams["shared"]["attn"], cfg, params["shared"]["attn"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    return jcfg, jp, cfg, params["layers"][0]["attn"]


@pytest.mark.parametrize("pos", [
    10, T - 1, T, 1000,                       # one pos for every row
    [5, T - 1, T, 1000],                      # mixed per-row pos
    [0, 3 * T - 1, 2 * T + 7, T + 1]])
def test_windowed_decode_matches_reference_ring(layer, pos):
    jcfg, jp, cfg, p = layer
    assert cfg.sliding_window == T
    rng = np.random.default_rng(T if isinstance(pos, int) else sum(pos))
    x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    pos_np = np.asarray(pos, np.int32)
    want, jcache = jattn.apply_attention_decode(
        jcfg, jp, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos_np))
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    before = dict(ops.LAUNCHES)
    got, cache = attn.apply_attention_decode(cfg, p, torch.tensor(x), cache,
                                             torch.tensor(pos_np))
    assert ops.LAUNCHES == before            # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):       # the new token's row, at slot pos % T
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_windowed_decode_calls_the_kernel_wrapper(layer, monkeypatch):
    """The ring branch is gone: a windowed step is one `ops.decode_attention`
    call with the raw per-row pos, never a ring mask."""
    _, _, cfg, p = layer
    calls = []
    real = ops.decode_attention

    def spy(q, k, v, pos):
        calls.append(pos.clone())
        return real(q, k, v, pos)

    monkeypatch.setattr(ops, "decode_attention", spy)
    cache = {n: torch.zeros((2, T, cfg.n_kv_heads, cfg.head_dim))
             for n in ("k", "v")}
    attn.apply_attention_decode(cfg, p, torch.ones((2, 1, cfg.d_model)),
                                cache, torch.tensor([3, 700]))
    assert len(calls) == 1 and calls[0].tolist() == [3, 700]
