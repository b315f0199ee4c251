"""The grid engine's tail lowering (`repro_torch.core.relax`,
``lowering="tail"``) against the JAX package's default CPU lowering, on the
CPU.

* `_grid_tail_bracket` on seeded random rows and on degenerate ones (every
  arm tied, a free arm beside a capped μ̄ = 1, ρ unattainable, feasible at
  λ = 0), with either matroid: the λ brackets bit-equal, z̃ within 1e-6.
* Warm-started and cold Frank-Wolfe each against the reference's (z̃
  within 1e-6), and warm against cold as the reference's own test holds
  them (the test's docstring says why the 2e-6 recorded for the warm
  start in CHANGES.md is not held two-sided).
* A mixed batch (`_solve_ix_unified`) against the reference's
  `solve_batch`, and bit-identical to the port's single-kind rows.
* `LocalServer(lowering="tail")` against the reference's `LocalServer` on
  every round from t = 1, degenerate rounds included (the wide lowering
  picks another optimum there, which is why
  `test_torch_router.py::test_local_server_tracks_the_reference` primes
  its servers first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import relax as jrelax
from repro.core import rewards as jR
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.env import llm_profiles as jprof
from repro.router import local_server as jls
from repro_torch import convert
from repro_torch.core import relax
from repro_torch.router import local_server

torch.set_num_threads(1)
K = 9


def _rows(seed=0, b=48):
    """Random rows, then degenerate ones: all arms tied; a free arm beside
    capped μ̄ = 1 arms; ρ below the cheapest n-subset; ρ feasible at λ = 0
    (the top-n by w already within budget)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (b, K))
    c = rng.uniform(0.01, 0.6, (b, K))
    n = rng.integers(1, K, b)
    rho = np.sort(c, 1).cumsum(1)[np.arange(b), n - 1] * rng.uniform(1.05,
                                                                     2.5, b)
    w[0], c[0], n[0], rho[0] = 1.0, 0.3, 3, 0.5                 # all tied
    w[1, :4], c[1, 2] = 1.0, 0.0                                # free arm
    w[2, 5:] = w[2, 5]                                          # partial tie
    c[2, 5:] = c[2, 5]
    rho[3] = np.sort(c[3])[: n[3]].sum() * 0.5                  # unattainable
    rho[4] = c[4].sum()                                         # λ = 0
    w[5] = -w[5]                                                # no positive
    return (w.astype(np.float32), c.astype(np.float32), n.astype(np.int32),
            rho.astype(np.float32))


@pytest.mark.parametrize("equality", [True, False])
def test_grid_tail_bracket_matches_the_reference(equality):
    w, c, n, rho = _rows(1)
    jz, jlo, jhi = jax.vmap(
        lambda *a: jrelax._grid_tail_bracket(*a, equality))(
            *(jnp.asarray(x) for x in (w, c, n, rho)))
    z, lo, hi = relax._grid_tail_bracket(
        *(torch.tensor(x) for x in (w, c, n, rho)), equality)
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    # the one-shot form, and `lp_topn` on the tail lowering, are the same z̃
    assert torch.equal(relax._grid_tail(*(torch.tensor(x) for x in
                                          (w, c, n, rho)), equality), z)
    assert torch.equal(relax.lp_topn(torch.tensor(w), torch.tensor(c),
                                     torch.tensor(n), torch.tensor(rho),
                                     equality, lowering="tail"), z)
    # with n arms required, the unattainable row returns the cap vertex,
    # over budget; the inclusive matroid meets it with fewer arms
    over = float((z[3] * torch.tensor(c[3])).sum()) > rho[3]
    assert over == equality


def _awc_rows():
    """`tests/test_relax_rounding.py:make_instance`'s 120 instances (K in
    3..8, padded to K = 9 by arms of zero reward, which the inclusive
    matroid never selects), then `_rows`' random and degenerate ones."""
    rows = []
    for seed in range(120):
        rng = np.random.default_rng(seed)
        k = int(rng.integers(3, 9))
        n = int(rng.integers(1, k))
        mu = rng.uniform(0.05, 0.99, k)
        c = rng.uniform(0.01, 0.6, k)
        rho = float(np.sort(c)[:n].sum() * rng.uniform(1.05, 2.5))
        rows.append((np.r_[mu, np.zeros(K - k)], np.r_[c, np.full(K - k, .5)],
                     n, rho))
    w, c, n, rho = _rows(2, b=40)
    rows += list(zip(np.clip(w, 0, 1), c, n, rho))
    mu, c, n, rho = (np.asarray(x) for x in zip(*rows))
    return (mu.astype(np.float32), c.astype(np.float32), n.astype(np.int32),
            rho.astype(np.float32))


def _objective(z, mu):
    return np.asarray(jax.vmap(lambda zz, mm: jR.relaxed_reward("awc", zz,
                                                                mm))(
        jnp.asarray(z), jnp.asarray(mu)))


def test_warm_frank_wolfe_matches_cold_and_the_reference():
    """Warm and cold each equal the reference's (z̃ within 1e-6). Warm
    against cold is held as the reference holds it
    (`test_relax_rounding.py::test_awc_warm_fw_matches_cold_fw_decisions`):
    the warm objective at least the cold one less 2e-4, z̃ bit-identical on
    nine rows in ten. The reference's own warm − cold spans −2.3e-6 ..
    +1.6e-4 on its corpus and −1.8e-4 .. +1.9e-3 on the degenerate rows, so
    a two-sided 2e-6 holds in neither."""
    mu, c, n, rho = _awc_rows()
    kind = np.zeros(len(n), np.int32)
    args = tuple(torch.tensor(x) for x in (kind, mu, c, n, rho))
    port = {warm: relax.solve_batch(*args, lowering="tail",
                                    fw_warm=warm).numpy()
            for warm in (True, False)}
    jargs = tuple(jnp.asarray(x) for x in (kind, mu, c, n, rho))
    ref = {warm: np.asarray(jrelax.solve_batch(*jargs, kinds_present=(0,),
                                               fw_warm=warm))
           for warm in (True, False)}
    obj = {k: _objective(v, mu) for k, v in port.items()}
    for warm in (True, False):
        np.testing.assert_allclose(port[warm], ref[warm], atol=1e-6, rtol=0)
        np.testing.assert_allclose(obj[warm], _objective(ref[warm], mu),
                                   atol=1e-6, rtol=0)
    assert np.all(obj[True] >= obj[False] - 2e-4)
    same = np.all(port[True] == port[False], axis=1)
    assert same.mean() >= 0.9, same.mean()
    assert np.all((c * port[True]).sum(1) <= rho * 1.01 + 1e-4)
    # fw_warm acts on the tail lowering only: the wide one ignores it
    one = tuple(a[:8] for a in args)
    assert torch.equal(relax.solve_batch(*one, fw_warm=False),
                       relax.solve_batch(*one, fw_warm=True))


def _mixed():
    w, c, n, rho = _rows(3, b=45)
    kind = np.arange(len(n)) % 3
    mu = np.clip(np.abs(w), 0, 1).astype(np.float32)
    mu[6::7, :3] = 1.0                                      # unexplored arms
    return kind.astype(np.int32), mu, c, n, rho


def test_unified_batch_matches_the_reference_and_the_single_kind_rows():
    kind, mu, c, n, rho = _mixed()
    got = relax.solve_batch(*(torch.tensor(x) for x in (kind, mu, c, n,
                                                        rho)),
                            lowering="tail")
    want = np.asarray(jrelax.solve_batch(*(jnp.asarray(x) for x in
                                           (kind, mu, c, n, rho))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    for k in range(3):
        r = kind == k
        one = relax.solve_batch(*(torch.tensor(x[r]) for x in
                                  (kind, mu, c, n, rho)), lowering="tail")
        assert torch.equal(one, got[torch.tensor(r)]), k
    with pytest.raises(ValueError, match="unknown grid lowering"):
        relax.solve_batch(*(torch.tensor(x) for x in (kind, mu, c, n, rho)),
                          lowering="narrow")


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_local_server_on_the_tail_lowering_tracks_the_reference(kind):
    """Every round from t = 1, with no arm observed first: the early rounds
    are degenerate (every μ̄ capped at 1, arms tied in c̲)."""
    pool = jprof.paper_pool("sciq")
    jpc = JPolicyConfig(kind=kind, k=pool.k, n=4,
                        rho=jprof.default_rho(pool, kind, 4), delta=1 / 64,
                        alpha_mu=0.1, alpha_c=0.01)
    ref = jls.LocalServer(jpc)
    port = local_server.LocalServer(convert.policy_config(jpc), device="cpu",
                                    lowering="tail")
    rng = np.random.default_rng(5)
    for _ in range(16):
        zj, zp = ref.relaxed_selection(), port.relaxed_selection()
        np.testing.assert_allclose(zp, np.asarray(zj), atol=1e-5, rtol=0)
        p = np.clip(np.asarray(zj, np.float64), 0, None) + 1e-3
        arm = int(rng.choice(pool.k, p=p / p.sum()))
        reward = float(rng.choice(pool.reward_levels))
        cost = float(pool.mean_cost[arm] * rng.uniform(0.5, 1.5))
        ref.record(arm, reward, cost)
        port.record(arm, reward, cost)
    assert port.t == ref.t == 16
