"""The port's relaxed solve (`repro_torch.core.relax`, the wide lowering)
against the JAX package, on the CPU.

The reference is the JAX wide lowering — ``REPRO_TOPN_LP_PALLAS=1``,
``REPRO_AWC_FW_PALLAS=1`` with `repro.kernels.ref`'s kernels — run op by op
under `jax.disable_jit()`, where every op rounds once as the port's eager
ops do. (Compiled by XLA on the CPU, that lowering contracts w − λc into
FMAs and can return an over-budget AWC vertex; ROADMAP.md, Queue 3.) z̃ is
held to atol 1e-5 and the objective to 1e-5; against the reference's bisect
engine, the objective to the reference's own grid ≡ bisect bound, 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandit as jbandit
from repro.core import relax as jrelax
from repro.core import rewards as jR
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.env.llm_profiles import default_rho, paper_pool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bandit, relax
from repro_torch.core import rewards as R
from repro_torch.core.policies import PolicyConfig

torch.set_num_threads(1)
K = 9


def _instances():
    """Mixed-kind rows on the paper pool (with ties: unexplored arms at
    μ̄ = 1, free arms at c̲ = 0) and random rows; kind, μ̄, c̲, n, ρ and
    whether ρ is attainable (AWC, an inclusive matroid, always; SUC/AIC when
    ρ covers the cheapest n-subset)."""
    pool = paper_pool("sciq")
    rng = np.random.default_rng(0)
    rows = []
    for kind in (0, 1, 2):
        for n in (2, 3, 4, 5):
            for scale in (0.9, 1.0, 1.5):
                mu = np.clip(pool.mu + rng.normal(0, 0.15, K), 0, 1)
                mu[rng.uniform(size=K) < 0.3] = 1.0       # unexplored arms
                c = pool.mean_cost * rng.uniform(0.4, 1.0, K)
                c[rng.uniform(size=K) < 0.2] = 0.0
                kname = ("awc", "suc", "aic")[kind]
                rows.append((kind, mu, c, n,
                             default_rho(pool, kname, n) * scale))
        for seed in range(12):                 # after make_instance, K = 9
            r = np.random.default_rng(1000 * kind + seed)
            n = int(r.integers(1, K))
            mu = r.uniform(0.05, 0.99, K)
            c = r.uniform(0.01, 0.6, K)
            rows.append((kind, mu, c, n,
                         float(np.sort(c)[:n].sum() * r.uniform(1.05, 2.5))))
        c = rng.uniform(0.1, 0.6, K)           # unattainable budget: λ-cap
        rows.append((kind, rng.uniform(0.05, 0.99, K), c, 3,
                     float(np.sort(c)[:3].sum() * 0.5)))
    kind_ix, mu, c, n, rho = (np.asarray(x) for x in zip(*rows))
    attainable = (kind_ix == 0) | (rho >= np.sort(c, 1).cumsum(1)[
        np.arange(len(n)), n - 1])
    return (kind_ix.astype(np.int32), mu.astype(np.float32),
            c.astype(np.float32), n.astype(np.int32), rho.astype(np.float32),
            attainable)


def _objective(kind_ix, z, mu):
    return np.asarray([float(jR.relaxed_reward(jR.KINDS[k], jnp.asarray(zz),
                                               jnp.asarray(mm)))
                       for k, zz, mm in zip(kind_ix, z, mu)])


@pytest.fixture(scope="module")
def solved():
    """(instances, port z̃, eager wide-lowering z̃, bisect z̃)."""
    kind_ix, mu, c, n, rho, att = _instances()
    z_port = relax.solve_batch(torch.tensor(kind_ix), torch.tensor(mu),
                               torch.tensor(c), torch.tensor(n),
                               torch.tensor(rho)).numpy()
    args = tuple(jnp.asarray(x) for x in (kind_ix, mu, c, n, rho))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TOPN_LP_PALLAS", "1")
        mp.setenv("REPRO_AWC_FW_PALLAS", "1")
        mp.setattr(jops, "topn_lp", jref.topn_lp)
        mp.setattr(jops, "awc_fw", jref.awc_fw)
        jax.clear_caches()
        try:
            with jax.disable_jit():
                z_wide = np.asarray(jrelax.solve_batch(*args))
        finally:
            jax.clear_caches()
    z_bis = np.asarray(jrelax.solve_batch(*args, engine="bisect"))
    return (kind_ix, mu, c, n, rho, att), z_port, z_wide, z_bis


def test_solve_batch_matches_wide_lowering(solved):
    (kind_ix, mu, c, n, rho, att), z_port, z_wide, _ = solved
    np.testing.assert_allclose(z_port, z_wide, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_objective(kind_ix, z_port, mu),
                               _objective(kind_ix, z_wide, mu), atol=1e-5)


def test_solve_batch_paper_pool_rows_bit_equal(solved):
    """On the paper-pool rows the two agree to the bit (same ops, each
    rounded once, same order of summation where it matters)."""
    _, z_port, z_wide, _ = solved
    paper = np.r_[0:12, 25:37, 50:62]
    assert np.array_equal(z_port[paper], z_wide[paper])


def test_solve_batch_objective_within_bisect_bound(solved):
    (kind_ix, mu, c, n, rho, att), z_port, _, z_bis = solved
    v_port = _objective(kind_ix, z_port, mu)
    v_bis = _objective(kind_ix, z_bis, mu)
    assert np.all(v_port[att] >= v_bis[att] - 1e-5)
    cost = (c * z_port).sum(1)
    assert np.all(cost[att] <= rho[att] * 1.002 + 1e-5)
    assert np.all(z_port >= -1e-6) and np.all(z_port <= 1 + 1e-6)
    eq = (kind_ix != 0) & att
    assert np.all(np.abs(z_port[eq].sum(1) - n[eq]) < 1e-3)
    # the LP-optimum shape, on the random (non-degenerate) rows
    frac = ((z_port > 1e-5) & (z_port < 1 - 1e-5)).sum(1)
    random_eq = np.zeros_like(eq)
    random_eq[np.r_[37:49, 62:74]] = True
    assert np.all(frac[random_eq & eq] <= 2)


def test_unattainable_budget_returns_the_cap_vertex(solved):
    """SUC/AIC with ρ below the cheapest n-subset: both solvers return the
    same λ-cap vertex, which violates the budget (the reference's documented
    degradation)."""
    (kind_ix, mu, c, n, rho, att), z_port, z_wide, _ = solved
    assert (~att).sum() == 2
    assert np.array_equal(z_port[~att], z_wide[~att])
    assert np.all((c * z_port).sum(1)[~att] > rho[~att])


def test_solve_relaxed_is_a_row_of_solve_batch(solved):
    (kind_ix, mu, c, n, rho, _), z_port, _, _ = solved
    for i in (0, 13, 30, 55, 70):
        z = relax.solve_relaxed(R.KINDS[kind_ix[i]], torch.tensor(mu[i]),
                                torch.tensor(c[i]), int(n[i]), float(rho[i]),
                                device="cpu")
        assert np.array_equal(z.numpy(), z_port[i])


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_solve_direct_and_optimal_value_match(kind):
    pool = paper_pool("sciq")
    for n in (2, 4):
        rho = default_rho(pool, kind, n)
        for eq in (True, False):
            assert np.array_equal(relax.enumerate_actions(K, n, eq),
                                  jrelax.enumerate_actions(K, n, eq))
        s_p, v_p = relax.solve_direct(kind, pool.mu, pool.mean_cost, n, rho)
        s_j, v_j = jrelax.solve_direct(kind, pool.mu, pool.mean_cost, n, rho)
        assert np.array_equal(s_p, s_j) and v_p == v_j
        pc = PolicyConfig(kind=kind, k=K, n=n, rho=rho)
        jpc = JPolicyConfig(kind=kind, k=K, n=n, rho=rho)
        assert bandit.optimal_value(pool, pc) == \
            jbandit.optimal_value(pool, jpc)


# ====================================================== engines and knobs
def test_bisect_engine_matches_the_reference_bisect(solved):
    """``engine="bisect"`` against the reference's bisect engine (both
    compile or run their score as one multiply-add), z̃ within 1e-5."""
    (kind_ix, mu, c, n, rho, _), _, _, z_bis = solved
    z = relax.solve_batch(torch.tensor(kind_ix), torch.tensor(mu),
                          torch.tensor(c), torch.tensor(n), torch.tensor(rho),
                          engine="bisect").numpy()
    np.testing.assert_allclose(z, z_bis, atol=1e-5, rtol=0)
    for i in (0, 13, 30, 55, 70):
        zi = relax.solve_relaxed(R.KINDS[kind_ix[i]], mu[i], c[i], int(n[i]),
                                 float(rho[i]), engine="bisect", device="cpu")
        np.testing.assert_allclose(zi.numpy(), z_bis[i], atol=1e-5, rtol=0)
    eq = np.nonzero(kind_ix == 1)[0][:6]
    zl = relax.lp_topn(torch.tensor(mu[eq]), torch.tensor(c[eq]),
                       torch.tensor(n[eq]), torch.tensor(rho[eq]), True,
                       engine="bisect")
    assert torch.equal(zl, relax.lp_topn_dyn(
        torch.tensor(mu[eq]), torch.tensor(c[eq]), torch.tensor(n[eq]),
        torch.tensor(rho[eq]), True, engine="bisect"))
    np.testing.assert_allclose(zl.numpy(), z_bis[eq], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown LP engine"):
        relax.lp_topn(torch.tensor(mu[eq]), torch.tensor(c[eq]), 2, 1.0, True,
                      engine="simplex")


F6_SEEDS = (161, 378, 560, 1885, 4892)   # ROADMAP F6: grid ≠ bisect there


def _f6_instance(seed):
    """`tests/test_relax_rounding.py:make_instance` (K in 3..8)."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 9))
    n = int(rng.integers(1, k))
    mu = rng.uniform(0.05, 0.99, k)
    c = rng.uniform(0.01, 0.6, k)
    rho = float(np.sort(c)[:n].sum() * rng.uniform(1.05, 2.5))
    return mu.astype(np.float32), c.astype(np.float32), n, rho


@pytest.mark.parametrize("seed", F6_SEEDS)
def test_bisect_engine_at_the_f6_seeds(seed):
    """The instances where the reference's grid and bisect engines part
    (F6): the port's bisect engine is still the reference's bisect, and
    its grid engine is reported against it, not dropped."""
    mu, c, n, rho = _f6_instance(seed)
    for kind in ("suc", "aic", "awc"):
        want = np.asarray(jrelax.solve_relaxed(
            kind, jnp.asarray(mu), jnp.asarray(c), n, rho, engine="bisect"))
        got = relax.solve_relaxed(kind, mu, c, n, rho, engine="bisect",
                                  device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        grid = relax.solve_relaxed(kind, mu, c, n, rho, device="cpu").numpy()
        assert float(c @ grid) <= rho * 1.002 + 1e-5
        assert np.all(grid >= -1e-6) and np.all(grid <= 1 + 1e-6)


def test_fw_steps_match_the_wide_lowering(solved):
    """``fw_steps`` 4, 8 and 16 on the AWC rows (with the F6 instances' AWC
    rows padded to K = 9 by zero-reward arms) against the JAX wide lowering
    op by op (one run for the three, which share its op caches)."""
    (kind_ix, mu, c, n, rho, _), _, _, _ = solved
    awc = np.nonzero(kind_ix == 0)[0][::2]
    rows = [(mu[i], c[i], n[i], rho[i]) for i in awc]
    for seed in F6_SEEDS:
        m, cc, nn, rr = _f6_instance(seed)
        pad = K - len(m)
        rows.append((np.r_[m, np.zeros(pad, np.float32)],
                     np.r_[cc, np.full(pad, 0.5, np.float32)], nn, rr))
    m, cc, nn, rr = (np.asarray(x) for x in zip(*rows))
    args = (np.zeros(len(nn), np.int32), m.astype(np.float32),
            cc.astype(np.float32), nn.astype(np.int32), rr.astype(np.float32))
    steps = (4, 8, 16)
    got = [relax.solve_batch(*(torch.tensor(a) for a in args),
                             fw_steps=s).numpy() for s in steps]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TOPN_LP_PALLAS", "1")
        mp.setenv("REPRO_AWC_FW_PALLAS", "1")
        mp.setattr(jops, "topn_lp", jref.topn_lp)
        mp.setattr(jops, "awc_fw", jref.awc_fw)
        jax.clear_caches()
        try:
            with jax.disable_jit():
                want = [np.asarray(jrelax.solve_batch(
                    *(jnp.asarray(a) for a in args), kinds_present=(0,),
                    fw_steps=s)) for s in steps]
        finally:
            jax.clear_caches()
    for s, g, w in zip(steps, got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=str(s))
    assert not np.array_equal(got[0], got[2])
