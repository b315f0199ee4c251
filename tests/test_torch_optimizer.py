"""The port's optimizers (`repro_torch.train.optimizer`) against the JAX
package's, on the CPU, over a reduced StarCoder2's parameter tree (the
reference's stacked layers carried across by `convert`).

`lr_schedule` is held to float32 rounding (rtol 1e-6: the reference takes
its cosine in float32, the port in float64 rounded once); `global_norm`
to 1e-6 relative (the order of the sums differs); AdamW and SGD-M params,
moments and master weights to atol 1e-6 over 1 and 3 steps, with the
gradient clip off and active, from the same state (`convert.
adamw_state_from_jax`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)
ARCH = "starcoder2-7b"
jadamw = jax.jit(jopt.adamw_update, static_argnums=0)


@pytest.fixture(scope="module")
def trees():
    """(JAX params, JAX grads a step, port cfg) at the reduced config."""
    jparams = jax.tree.map(np.asarray, JM.init_params(
        jget_config(ARCH).reduced(), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01)
                          .astype(np.float32), jparams) for _ in range(3)]
    return jparams, grads, get_config(ARCH).reduced()


def _close(got, want, atol=1e-6):
    """A port tree against a JAX one (its layers stacked), leaf by leaf."""
    want = opt.tree_leaves(convert.tree_from_jax(want, "cpu"))
    got = opt.tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("step", [0, 9, 10, 55, 100, 150])
def test_lr_schedule_matches_the_reference(step):
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = float(jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got == float(np.float32(got))


def test_global_norm_matches_the_reference(trees):
    jparams, grads, _ = trees
    want = float(jopt.global_norm(grads[0]))
    got = opt.global_norm(convert.tree_from_jax(grads[0],
                                                 "cpu"))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_the_reference(trees, clip, steps):
    """clip 0 turns the clip off; 0.05 is below every step's gradient norm
    (~0.5 here), so it scales each step."""
    jparams, grads, cfg = trees
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg, ocfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jst = jopt.init_adamw(jcfg, jparams)
    params = convert.params_from_jax(cfg, jparams, device="cpu")
    st = convert.adamw_state_from_jax(jst, device="cpu")
    jp = jparams
    for i in range(steps):
        jp, jst, jm = jadamw(jcfg, grads[i], jst, jp)
        params, st, m = opt.adamw_update(
            ocfg, convert.tree_from_jax(grads[i], "cpu"), st,
            params)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(st["step"]) == int(jst["step"]) == steps
    _close(params, jax.tree.map(np.asarray, jp))
    for k in ("m", "v", "master"):
        _close(st[k], jax.tree.map(np.asarray, jst[k]))
    if clip:
        assert float(m["grad_norm"]) > clip


def test_adamw_keeps_bf16_params_over_fp32_master(trees):
    jparams, grads, cfg = trees
    ocfg = opt.AdamWConfig()
    params = opt.tree_map(lambda p: p.to(torch.bfloat16),
                          convert.params_from_jax(cfg, jparams, device="cpu"))
    st = opt.init_adamw(ocfg, params)
    new, st, _ = opt.adamw_update(
        ocfg, convert.tree_from_jax(grads[0], "cpu"), st,
        params)
    for p, mw, m in zip(opt.tree_leaves(new), opt.tree_leaves(st["master"]),
                        opt.tree_leaves(st["m"])):
        assert p.dtype == torch.bfloat16
        assert mw.dtype == m.dtype == torch.float32
        assert torch.equal(p, mw.to(torch.bfloat16))


def test_sgdm_update_matches_the_reference(trees):
    jparams, grads, cfg = trees
    jst = jopt.init_sgdm(jparams)
    params = convert.params_from_jax(cfg, jparams, device="cpu")
    st = opt.init_sgdm(params)
    jp = jparams
    for g in grads:
        jp, jst, _ = jopt.sgdm_update(g, jst, jp, lr=0.05)
        params, st, _ = opt.sgdm_update(
            convert.tree_from_jax(g, "cpu"), st, params,
            lr=0.05)
    assert int(st["step"]) == 3
    _close(params, jax.tree.map(np.asarray, jp))
    _close(st["mu"], jax.tree.map(np.asarray, jst["mu"]))
