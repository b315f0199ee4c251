"""The port's MoE family (`repro_torch.models.moe` and the MoE blocks of
`models.blocks`) against the JAX package, on the CPU, at the reduced
OLMoE / Arctic sizes (4 experts, top 2, d_model 256, float32), with JAX's
own weights carried across and inputs from a numpy seed.

Tolerances:

* `route`: the chosen experts bit-equal, in JAX's order, ties to the lower
  expert index; gates and probabilities within 1e-6 (a softmax over 4
  logits in another order of sums).
* `apply_moe` at capacity 0.25 (entries dropped), 1.25 (the configs') and
  64 (none dropped): y at atol = rtol = 2e-5, `tests/test_torch_model.py`'s
  tolerance, and the load-balance loss at 1e-6. The dropped set is JAX's
  exactly: a token dropped on one side and kept on the other would move y
  by the size of an expert's output, far outside 2e-5.
* The three block forms (forward, prefill with its cache, a decode step at
  per-row positions) at 2e-5, for OLMoE and for Arctic's dense residual.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import blocks
from repro_torch.models import moe

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, MAX_LEN = 2, 24, 32


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "arctic-480b"])
def layer(request):
    """(JAX cfg, JAX layer 0, port cfg, port layer 0) of the reduced config,
    JAX's weights."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return (jcfg, jax.tree.map(lambda a: a[0], jparams["layers"]), cfg,
            params["layers"][0])


@pytest.fixture(scope="module")
def olmoe():
    """(JAX cfg, port cfg, MoE weights as numpy) of the reduced OLMoE."""
    jcfg = jget_config("olmoe-1b-7b").reduced()
    cfg = get_config("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(0)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": rng.standard_normal((d, e), dtype=np.float32) * 0.05,
         "wi_gate": rng.standard_normal((e, d, f), dtype=np.float32) * 0.05,
         "wi_up": rng.standard_normal((e, d, f), dtype=np.float32) * 0.05,
         "wo": rng.standard_normal((e, f, d), dtype=np.float32) * 0.05}
    return jcfg, cfg, p


def activations(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,), dtype=np.float32)


def test_route_matches_reference(olmoe):
    jcfg, cfg, p = olmoe
    x = activations(cfg, (B, S), 1)
    jg, jidx, jprobs = jmoe.route(jcfg, {"router": jnp.asarray(p["router"])},
                                  jnp.asarray(x))
    g, idx, probs = moe.route(cfg, {"router": t(p["router"])}, t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(g, jg, dict(atol=1e-6, rtol=0))
    close(probs, jprobs, dict(atol=1e-6, rtol=0))
    assert g.dtype == probs.dtype == torch.float32


def test_route_ties_go_to_the_lower_expert(olmoe):
    """Experts 1 and 3 have zero router columns, so their logits are both
    exactly 0 for every token. Where one of experts 0 and 2 scores above 0,
    the tie sits on the top-2 boundary and expert 1 takes it; where both
    score below 0, the top 2 are [1, 3] in that order; expert 3 never comes
    alone or first."""
    jcfg, cfg, p = olmoe
    router = p["router"].copy()
    router[:, [1, 3]] = 0.0
    x = activations(cfg, (B, S), 2)
    _, jidx, _ = jmoe.route(jcfg, {"router": jnp.asarray(router)},
                            jnp.asarray(x))
    _, idx, probs = moe.route(cfg, {"router": t(router)}, t(x))
    assert torch.equal(probs[..., 1], probs[..., 3])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    has3 = (idx == 3).any(-1)
    assert (idx[has3] == torch.tensor([1, 3])).all()
    assert has3.any() and (idx[..., 1] == 1).any()   # both tie cases occur


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 64.0])
def test_apply_moe_matches_reference(olmoe, capacity_factor):
    jcfg, cfg, p = olmoe
    x = activations(cfg, (B, S), 3)
    jy, jaux = jmoe.apply_moe(jcfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x),
                              capacity_factor=capacity_factor)
    y, aux = moe.apply_moe(cfg, {k: t(v) for k, v in p.items()}, t(x),
                           capacity_factor=capacity_factor)
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, jy)
    close(aux, jaux, dict(atol=1e-6, rtol=0))
    if capacity_factor < 1:
        # as tests/test_extensions.py: the tight capacity really drops
        full, _ = moe.apply_moe(cfg, {k: t(v) for k, v in p.items()}, t(x),
                                capacity_factor=64.0)
        assert (y - full).abs().max().item() > 1e-5


def test_capacity_is_the_reference_arithmetic():
    """Python float arithmetic, as JAX's: OLMoE (E 64, K 8, 1.25) takes 160
    / 320 / 469 slots at 1,024 / 2,048 / 3,000 tokens and 1 in a decode
    step."""
    cfg = get_config("olmoe-1b-7b")
    got = [moe.capacity(s, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
           for s in (1024, 2048, 3000, 1)]
    assert got == [160, 320, 469, 1]


def test_local_dispatch_matches_reference(olmoe):
    """`_local_dispatch` (one group, `apply_moe_ep`'s) against JAX's."""
    _, cfg, _ = olmoe
    rng = np.random.default_rng(4)
    n, e, cap = 40, cfg.n_experts, 7
    x = rng.standard_normal((n, 16), dtype=np.float32)
    eid = rng.integers(0, e, n).astype(np.int32)
    gat = rng.random(n, dtype=np.float32)
    jbuf, jorder, jdest, jkeep = jmoe._local_dispatch(
        jnp.asarray(x), jnp.asarray(eid), jnp.asarray(gat), e, cap)
    buf, order, dest, keep = moe._local_dispatch(t(x), t(eid).long(),
                                                 t(gat), e, cap)
    assert not keep.all()
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for got, want in ((order, jorder), (dest, jdest), (keep, jkeep)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_block_forward_matches_reference(layer):
    jcfg, jp, cfg, p = layer
    x = activations(cfg, (B, S), 5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, jaux = jblocks.apply_moe_block(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(pos))
    y, aux = blocks.apply_moe_block(cfg, p, t(x), t(pos))
    close(y, jy)
    close(aux, jaux, dict(atol=1e-6, rtol=0))


def test_moe_block_prefill_and_decode_match_reference(layer):
    """The prefill form fills the layer's cache in place; one decode step
    then runs at per-row positions (each row at its own slot)."""
    jcfg, jp, cfg, p = layer
    x = activations(cfg, (B, S), 6)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jy, jc = jblocks.apply_moe_block_prefill(jcfg, jp, jnp.asarray(x),
                                             jnp.asarray(pos), MAX_LEN)
    shape = (B, MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    y, c = blocks.apply_moe_block_prefill(cfg, p, t(x), t(pos), cache)
    close(y, jy)
    for name in ("k", "v"):
        assert c[name] is cache[name]
        close(cache[name], jc[name])
    x1 = activations(cfg, (B, 1), 7)
    at = np.array([S, S - 5], np.int32)
    jy1, jc1 = jblocks.apply_moe_block_decode(jcfg, jp, jnp.asarray(x1), jc,
                                              jnp.asarray(at))
    y1, _ = blocks.apply_moe_block_decode(cfg, p, t(x1), cache, t(at))
    close(y1, jy1)
    for name in ("k", "v"):
        close(cache[name], jc1[name])


def test_decode_step_drops_nothing(layer):
    """At the config's capacity a one-token step takes 1 slot an expert and
    a token's experts are distinct, so it equals the no-drop result."""
    _, _, cfg, p = layer
    x = t(activations(cfg, (B, 1), 8))
    y, _ = moe.apply_moe(cfg, p["moe"], x)
    wide = dataclasses.replace(cfg, capacity_factor=64.0)
    y64, _ = moe.apply_moe(wide, p["moe"], x)
    assert torch.equal(y, y64)
