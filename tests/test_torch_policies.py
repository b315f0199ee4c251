"""The port's §6 policies (`repro_torch.core.policies`) and its per-seed
bandit loop (`core.bandit.simulate`) against the JAX package, on the CPU.

Per decision, on the reference's corpus (`test_torch_fleet._corpus`: 150
(stats, t, key) rows, under AWC, SUC and AIC where the policy reads the
kind), every deterministic policy picks the reference's mask bit for bit.
The per-seed C2MAB-V is held per decision in `test_torch_fleet.py`,
against the JAX wide lowering run op by op there. Thompson sampling is
held on every row whose n-th and (n+1)-th sampled values lie more than
BETA_TOL apart (`prng.beta` agrees with `jax.random.beta` to BETA_TOL);
the other rows are counted, and none is expected. Whole runs of `simulate` are held on their first round and on
their curves (`test_torch_fleet`'s REWARD_TOL and VIOLATION_TOL): the cost
draws' −log drifts the statistics by ulps, which flips near-ties later.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandit as jbandit
from repro.core import policies as jpolicies
from repro.core import relax as jrelax
from repro.env.llm_profiles import default_rho, paper_pool as jpaper_pool
from repro_torch import convert, prng
from repro_torch.core import bandit, policies
from repro_torch.env.llm_profiles import paper_pool
from test_torch_fleet import _assert_curves, _corpus, _per_kind

torch.set_num_threads(1)
KINDS = ("awc", "suc", "aic")
BETA_TOL = 1e-6
T = 32


def _pcfgs(kind, pool, delta=1 / 60):
    jpc = jpolicies.PolicyConfig(kind=kind, k=pool.k, n=4,
                                 rho=default_rho(pool, kind, 4), delta=delta)
    return jpc, convert.policy_config(jpc)


def _policy_kw(name, kind, pool):
    if name == "fixed":
        return {"arm": 8}
    if name == "offline_fixed":
        s, _ = jrelax.solve_direct(kind, pool.mu, pool.mean_cost, 4,
                                   default_rho(pool, kind, 4))
        return {"mask": s.astype(np.float32)}
    return {}


@pytest.fixture(scope="module")
def corpus():
    pool = jpaper_pool("sciq")
    stats, ts, keys = _corpus(pool)
    tstats = {k: torch.tensor(v) for k, v in stats.items()}
    return (pool, stats, ts, keys, tstats, torch.tensor(ts),
            convert.key_rows(keys, "cpu"))


def _jax_masks(name, jpc, kw, stats, ts, keys):
    act = jpolicies.make_policy(name, jpc, **kw)
    return np.asarray(jax.jit(jax.vmap(act))(
        {k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(keys),
        jnp.asarray(ts)))


@pytest.mark.parametrize("name, kind", [
    ("c2mabv_direct", "awc"), ("c2mabv_direct", "suc"),
    ("c2mabv_direct", "aic"), ("offline_fixed", "awc"),
    ("offline_fixed", "suc"), ("offline_fixed", "aic"),
    # cost- and kind-blind: one kind each
    ("cucb", "suc"), ("egreedy", "suc"), ("fixed", "suc")])
def test_baseline_decisions_bit_equal(corpus, name, kind):
    pool, stats, ts, keys, tstats, tts, tkeys = corpus
    jpc, pc = _pcfgs(kind, pool)
    kw = _policy_kw(name, kind, pool)
    want = _jax_masks(name, jpc, kw, stats, ts, keys)
    got = policies.make_policy(name, pc, device="cpu", **kw)(
        tstats, tkeys, tts).numpy()
    bad = np.nonzero((want != got).any(-1))[0]
    assert bad.size == 0, bad
    if name in ("cucb", "egreedy"):
        assert (got.sum(-1) == 4).all()


def test_thompson_decisions_equal_off_near_ties(corpus):
    """Thompson sampling reads μ̂ and T only (not the kind, not the cost)."""
    pool, stats, ts, keys, tstats, tts, tkeys = corpus
    jpc, pc = _pcfgs("suc", pool)
    want = _jax_masks("thompson", jpc, {}, stats, ts, keys)
    got = policies.make_policy("thompson", pc, device="cpu")(
        tstats, tkeys, tts).numpy()
    s = stats["mu_hat"] * stats["t_mu"]
    f = stats["t_mu"] - s
    sample = np.asarray(jax.jit(jax.vmap(jax.random.beta))(
        jnp.asarray(keys), 1.0 + s, 1.0 + f))
    srt = -np.sort(-sample, axis=-1)
    near = srt[:, 3] - srt[:, 4] <= BETA_TOL
    assert near.sum() == 0, np.nonzero(near)[0]
    bad = np.nonzero((want != got).any(-1) & ~near)[0]
    assert bad.size == 0, bad
    # the draws themselves, within the stated tolerance
    tsample = prng.beta(tkeys, torch.tensor(1.0 + s),
                        torch.tensor(1.0 + f)).numpy()
    np.testing.assert_allclose(tsample, sample, atol=BETA_TOL, rtol=0)


@pytest.mark.parametrize("name", ["c2mabv", "c2mabv_direct", "cucb",
                                  "thompson", "egreedy", "fixed",
                                  "offline_fixed"])
def test_simulate_per_seed_tracks_the_reference(name):
    """Every policy through the per-seed loop at T = 32, 3 seeds, AWC."""
    pool = jpaper_pool("sciq")
    jpc, pc = _pcfgs("awc", pool, delta=1 / T)
    kw = _policy_kw(name, "awc", pool)
    ref = jbandit.simulate(name, pool, jpc, T=T, seeds=3, use_fleet=False,
                           **kw)
    port = bandit.simulate(name, paper_pool("sciq"), pc, T=T, seeds=3,
                           use_fleet=False, device="cpu", **kw)
    assert port.action.shape == ref.action.shape
    assert np.array_equal(port.action[:, 0], ref.action[:, 0])
    if name in ("fixed", "offline_fixed"):
        assert np.array_equal(port.action, ref.action)
    _assert_curves(_per_kind(port.reward, port.cost, ["awc"] * 3, [jpc] * 3),
                   _per_kind(ref.reward, ref.cost, ["awc"] * 3, [jpc] * 3),
                   ("awc",))
    assert (port.observed <= port.action).all()
    assert (port.action.sum(-1) <= 4).all()


def test_simulate_sync_every_holds_the_per_seed_action():
    pool = paper_pool("sciq")
    pc = policies.PolicyConfig(kind="suc", k=pool.k, n=4, rho=0.5,
                               delta=1 / T)
    res = bandit.simulate("cucb", pool, pc, T=9, seeds=2, sync_every=3,
                          device="cpu")
    for t in range(1, 9):
        if t % 3:
            assert (res.action[:, t] == res.action[:, t - 1]).all()
    assert (res.action.sum(-1) == 4).all()


def test_make_policy_names_match_the_reference():
    pool = paper_pool("sciq")
    pc = policies.PolicyConfig(kind="suc", k=pool.k, n=4, rho=0.5)
    for name in policies.NAMES:
        kw = {"arm": 0} if name == "fixed" else (
            {"mask": np.eye(pool.k)[0]} if name == "offline_fixed" else {})
        jpolicies.make_policy(name, jpolicies.PolicyConfig(
            kind="suc", k=pool.k, n=4, rho=0.5), **kw)
        policies.make_policy(name, pc, device="cpu", **kw)
    with pytest.raises(ValueError):
        policies.make_policy("nope", pc, device="cpu")
