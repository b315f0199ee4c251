"""The port's env and core modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Draws,
ranks, masks and feedback are held bit-equal; float scalars of the
confidence bounds to 1 ulp (XLA and torch may round log/sqrt chains and
contract a multiply-add differently); −log cost draws to rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import confidence as jcb
from repro.core import ranks as jranks
from repro.core import rewards as jR
from repro.core import rounding as jround
from repro.env import cost_model as jcost
from repro.env import feedback as jfb
from repro.env import llm_profiles as jprof
from repro.router import cloud as jcloud
from repro_torch import convert, prng
from repro_torch.core import confidence as cb
from repro_torch.core import ranks
from repro_torch.core import rewards as R
from repro_torch.core import rounding
from repro_torch.env import cost_model, feedback, llm_profiles
from repro_torch.router import cloud

torch.set_num_threads(1)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def ulps(a, b):
    """Distance in float32 ulps (same-sign finite values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ============================================================ llm_profiles
@pytest.mark.parametrize("scenario", ["sciq", "math", "chat"])
def test_paper_pool_copy_matches(scenario):
    a, b = jprof.paper_pool(scenario), llm_profiles.paper_pool(scenario)
    assert a.names == b.names and a.reward_levels == b.reward_levels
    assert np.array_equal(a.mu, b.mu)
    assert np.array_equal(a.mean_cost, b.mean_cost)
    assert a.cost_scale == b.cost_scale
    for kind in ("awc", "suc", "aic"):
        for n in (2, 4):
            assert jprof.default_rho(a, kind, n) == \
                llm_profiles.default_rho(b, kind, n)


# ============================================================== cost model
def _fleet_keys(seed, m):
    jk = jax.random.split(jax.random.PRNGKey(seed), m)
    return jk, convert.key_rows(np.asarray(jk), "cpu")


def test_sample_rewards_bit_equal():
    pool = jprof.paper_pool("sciq")
    mu = np.concatenate([pool.mu, [0.0, 0.01, 0.2, 0.6, 0.99, 1.0]])
    jk, tk = _fleet_keys(3, 64)
    want = np.asarray(jax.vmap(lambda k: jcost.sample_rewards(
        k, jnp.asarray(mu, jnp.float32), pool.reward_levels))(jk))
    got = cost_model.sample_rewards(tk, t(mu), pool.reward_levels).numpy()
    assert np.array_equal(want, got)


def test_sample_costs_match():
    pool = jprof.paper_pool("sciq")
    jk, tk = _fleet_keys(4, 64)
    want = np.asarray(jax.vmap(lambda k: jcost.sample_costs(
        k, jnp.asarray(pool.mean_cost, jnp.float32)))(jk))
    got = cost_model.sample_costs(tk, t(pool.mean_cost)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ================================================================ feedback
def _cascade_cases():
    rng = np.random.default_rng(5)
    k = 9
    mask = (rng.uniform(size=(200, k)) < 0.5).astype(np.float32)
    rew = rng.choice([0.0, 0.2, 0.6, 1.0], size=(200, k)).astype(np.float32)
    cost = rng.uniform(0.01, 0.8, size=(200, k)).astype(np.float32)
    cost[:40, 3] = cost[:40, 1]                 # duplicate-cost ties
    cost[:40, 7] = cost[:40, 1]
    rew[40:60] = 0.0                             # all fail
    rew[60:80] = 1.0                             # all succeed
    mask[80:90] = 0.0                            # nothing selected
    mask[90:100] = 1.0
    return mask, rew, cost


def test_awc_cascade_matches_jax_and_argsort_oracle():
    mask, rew, cost = _cascade_cases()
    want = np.asarray(jax.vmap(jfb._awc_cascade)(
        jnp.asarray(mask), jnp.asarray(rew), jnp.asarray(cost)))
    got = feedback._awc_cascade(t(mask), t(rew), t(cost)).numpy()
    oracle = feedback._awc_cascade_argsort(t(mask), t(rew), t(cost)).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(oracle, got)


def test_observe_ix_mixed_kinds():
    mask, rew, cost = _cascade_cases()
    kind_ix = np.arange(mask.shape[0]) % 3
    want = np.asarray(jax.vmap(jfb.observe_ix)(
        jnp.asarray(kind_ix), jnp.asarray(mask), jnp.asarray(rew),
        jnp.asarray(cost)))
    got = feedback.observe_ix(t(kind_ix, torch.int32), t(mask), t(rew),
                              t(cost)).numpy()
    assert np.array_equal(want, got)
    for kind in ("awc", "suc"):
        ref = np.asarray(jax.vmap(lambda m, r, c: jfb.observe(kind, m, r, c))(
            jnp.asarray(mask), jnp.asarray(rew), jnp.asarray(cost)))
        assert np.array_equal(ref, feedback.observe(kind, t(mask), t(rew),
                                                    t(cost)).numpy())


# =================================================================== ranks
def _scores_with_ties(seed, b=64, k=9):
    rng = np.random.default_rng(seed)
    s = rng.choice(np.linspace(-1, 1, 7), size=(b, k)).astype(np.float32)
    s[::3] = rng.normal(size=(len(s[::3]), k)).astype(np.float32)
    return s


def test_stable_desc_ranks_and_topn_mask_bit_equal():
    s = _scores_with_ties(0)
    n = np.random.default_rng(1).integers(0, 10, s.shape[0]).astype(np.int32)
    assert np.array_equal(np.asarray(jranks.stable_desc_ranks(jnp.asarray(s))),
                          ranks.stable_desc_ranks(t(s)).numpy())
    for eq in (True, False):
        want = np.asarray(jranks.topn_mask(jnp.asarray(s), jnp.asarray(n), eq))
        assert np.array_equal(want, ranks.topn_mask(t(s), t(n, torch.int32),
                                                    eq).numpy())


def test_lagrangian_crossing_forms_bit_equal():
    """Ranks, vertices and costs of w − λc over a λ batch, with exact ties
    in w and in c (crossings exactly on the dyadic ladder)."""
    rng = np.random.default_rng(2)
    w = rng.choice([0.25, 0.5, 0.75, 1.0], size=(16, 9)).astype(np.float32)
    c = rng.choice([0.125, 0.25, 0.5], size=(16, 9)).astype(np.float32)
    lams = np.broadcast_to(np.float32([0, 0.5, 1, 2, 3, 4, 16]), (16, 7))
    n = rng.integers(1, 9, 16).astype(np.int32)
    for eq in (True, False):
        jm = np.asarray(jax.vmap(lambda a, b, l, m: jranks.lagrangian_topn_mask(
            a, b, l, m, eq))(jnp.asarray(w), jnp.asarray(c), jnp.asarray(lams),
                             jnp.asarray(n)))
        tm = ranks.lagrangian_topn_mask(t(w), t(c), t(lams), t(n, torch.int32),
                                        eq).numpy()
        assert np.array_equal(jm, tm)
        jc = np.asarray(jax.vmap(lambda a, b, l, m: jranks.lagrangian_topn_cost(
            a, b, l, m, eq))(jnp.asarray(w), jnp.asarray(c), jnp.asarray(lams),
                             jnp.asarray(n)))
        tc = ranks.lagrangian_topn_cost(t(w), t(c), t(lams),
                                        t(n, torch.int32), eq).numpy()
        np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)


# ============================================================== confidence
def _stats(seed, m=64, k=9):
    rng = np.random.default_rng(seed)
    t_mu = rng.integers(0, 40, (m, k)).astype(np.float32)
    return {"mu_hat": (rng.uniform(0, 1, (m, k)) * (t_mu > 0)).astype(
                np.float32),
            "c_hat": (rng.uniform(0, 0.7, (m, k)) * (t_mu > 0)).astype(
                np.float32),
            "t_mu": t_mu, "t_c": t_mu.copy()}, \
        rng.integers(1, 3000, m).astype(np.float32)


def test_confidence_bounds_within_one_ulp():
    stats, tt = _stats(7)
    delta, a_mu, a_c = 1 / 2000, 0.3, 0.01
    js = {k: jnp.asarray(v) for k, v in stats.items()}
    ts = {k: t(v) for k, v in stats.items()}
    jr = np.asarray(jax.vmap(lambda tk, tr: jcb.radius(tr, tk, 9, delta))(
        js["t_mu"], jnp.asarray(tt)))
    tr = cb.radius(t(tt), ts["t_mu"], 9, delta).numpy()
    fin = np.isfinite(jr)
    assert np.array_equal(fin, np.isfinite(tr))
    assert ulps(jr[fin], tr[fin]).max() <= 1
    ju = np.asarray(jax.vmap(lambda s, tr: jcb.reward_ucb(s, tr, delta, a_mu))(
        js, jnp.asarray(tt)))
    assert ulps(ju, cb.reward_ucb(ts, t(tt), delta, a_mu).numpy()).max() <= 1
    jl = np.asarray(jax.vmap(lambda s, tr: jcb.cost_lcb(s, tr, delta, a_c))(
        js, jnp.asarray(tt)))
    tl = cb.cost_lcb(ts, t(tt), delta, a_c).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1.2e-7, atol=1e-9)


def test_update_stats_within_one_ulp():
    stats, _ = _stats(8)
    rng = np.random.default_rng(9)
    f = (rng.uniform(size=stats["t_mu"].shape) < 0.5).astype(np.float32)
    x = rng.choice([0.0, 0.2, 0.6, 1.0], size=f.shape).astype(np.float32)
    y = rng.uniform(0, 1, size=f.shape).astype(np.float32)
    want = jcb.update_stats({k: jnp.asarray(v) for k, v in stats.items()},
                            jnp.asarray(f), jnp.asarray(x), jnp.asarray(y))
    got = cb.update_stats({k: t(v) for k, v in stats.items()}, t(f), t(x),
                          t(y))
    for name in ("t_mu", "t_c"):
        assert np.array_equal(np.asarray(want[name]), got[name].numpy())
    for name in ("mu_hat", "c_hat"):
        assert ulps(np.asarray(want[name]), got[name].numpy()).max() <= 1


# ================================================================= rewards
def test_rewards_match():
    rng = np.random.default_rng(10)
    mu = rng.uniform(0, 1, (32, 9)).astype(np.float32)
    z = rng.uniform(0, 1, (32, 9)).astype(np.float32)
    mask = (z > 0.5).astype(np.float32)
    kind_ix = np.arange(32) % 3
    for kind in ("awc", "suc", "aic"):
        np.testing.assert_allclose(
            R.set_reward(kind, t(mask), t(mu)).numpy(),
            np.asarray(jR.set_reward(kind, jnp.asarray(mask), jnp.asarray(mu))),
            rtol=2e-7, atol=1e-7)
        np.testing.assert_allclose(
            R.relaxed_reward(kind, t(z), t(mu)).numpy(),
            np.asarray(jR.relaxed_reward(kind, jnp.asarray(z),
                                         jnp.asarray(mu))),
            rtol=2e-6, atol=1e-7)
    want = np.asarray(jax.vmap(jR.set_reward_ix)(
        jnp.asarray(kind_ix), jnp.asarray(mask), jnp.asarray(mu)))
    np.testing.assert_allclose(
        R.set_reward_ix(t(kind_ix, torch.int32), t(mask), t(mu)).numpy(),
        want, rtol=2e-7, atol=1e-7)
    np.testing.assert_allclose(
        R.awc_multilinear_grad(t(z), t(mu)).numpy(),
        np.asarray(jR.awc_multilinear_grad(jnp.asarray(z), jnp.asarray(mu))),
        atol=2e-6, rtol=0)
    assert R.KINDS == jR.KINDS and R.KIND_INDEX == jR.KIND_INDEX
    assert {k: float(v) for k, v in jR.ALPHA.items()} == pytest.approx(
        R.ALPHA, abs=1e-7)
    for kind in R.KINDS:
        assert R.equality_constrained(kind) == jR.equality_constrained(kind)


# ================================================================ rounding
def _fractional_rows(seed, m=96, k=9):
    """z̃ rows: LP-shaped (≤2 fractional), FW-shaped (many fractional) and
    near-integral rows inside and at the edges of the EPS band."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, (m, k)).astype(np.float32)
    z[: m // 3] = np.round(z[: m // 3])
    z[: m // 3, :2] = rng.uniform(0, 1, (m // 3, 2))
    band = np.float32([0.0, 5e-6, 1e-5, 1.2e-5, 1 - 1.2e-5, 1 - 1e-5,
                       1 - 5e-6, 1.0, 0.5])
    z[m // 3: m // 2] = rng.choice(band, size=(m // 2 - m // 3, k))
    return z


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_round_batch_bit_equal(seed):
    z = _fractional_rows(seed)
    jk, tk = _fleet_keys(seed + 20, z.shape[0])
    for trips in (0, None):      # reference's scan and while drivers
        want = np.asarray(jround.pairwise_round_batch(jnp.asarray(z), jk,
                                                      trips))
        got = rounding.pairwise_round_batch(t(z), tk).numpy()
        assert np.array_equal(want, got), trips


@pytest.mark.parametrize("trips", [0, None, 3])
def test_pairwise_round_single_row_loops_bit_equal(trips):
    """The single-row `pairwise_round` under each loop (K − 1 fixed trips,
    the while loop, 3 fixed trips) against the reference's, and against a
    row of `pairwise_round_batch` under the same loop."""
    z = _fractional_rows(5, m=8)
    jk, tk = _fleet_keys(40, z.shape[0])
    batch = rounding.pairwise_round_batch(t(z), tk, trips).numpy()
    for i in range(z.shape[0]):
        want = np.asarray(jround.pairwise_round(jnp.asarray(z[i]), jk[i],
                                                trips))
        got = rounding.pairwise_round(t(z[i]), tk[i], trips).numpy()
        assert np.array_equal(want, got), (i, trips)
        assert np.array_equal(batch[i], got), (i, trips)


def test_numpy_rounding_copies_match():
    """`pairwise_round_np`, `decompose_bases` and `swap_round_np` are the
    reference's numpy: the same draws from one seeded Generator."""
    z = _fractional_rows(6, m=30).astype(np.float64)
    for i, row in enumerate(z):
        want = jround.pairwise_round_np(row, np.random.default_rng(i))
        got = rounding.pairwise_round_np(row, np.random.default_rng(i))
        assert np.array_equal(want, got), i
        n = 4
        zz = np.clip(row, 0, 1) * min(1.0, n / max(row.sum(), 1e-9))
        w1, b1 = jround.decompose_bases(zz, n)
        w2, b2 = rounding.decompose_bases(zz, n)
        assert w1 == w2 and all(np.array_equal(a, b) for a, b in zip(b1, b2))
        want = jround.swap_round_np(zz, n, np.random.default_rng(50 + i))
        got = rounding.swap_round_np(zz, n, np.random.default_rng(50 + i))
        assert np.array_equal(want, got), i
        assert got.sum() <= n


def test_pad_to_n_dyn_and_round_batch_bit_equal():
    z = _fractional_rows(3)
    m = z.shape[0]
    rng = np.random.default_rng(4)
    n = rng.integers(1, 8, m).astype(np.int32)
    kind_ix = (np.arange(m) % 3).astype(np.int32)
    mask = (rng.uniform(size=z.shape) < 0.3).astype(np.float32)
    scores = rng.choice([0.1, 0.5, 0.9], size=z.shape).astype(np.float32)
    eq = kind_ix != 0
    want = np.asarray(jax.vmap(jround.pad_to_n_dyn)(
        jnp.asarray(mask), jnp.asarray(scores), jnp.asarray(n),
        jnp.asarray(eq)))
    got = rounding.pad_to_n_dyn(t(mask), t(scores), t(n, torch.int32),
                                torch.tensor(eq)).numpy()
    assert np.array_equal(want, got)
    jk, tk = _fleet_keys(5, m)
    want = np.asarray(jcloud.round_batch(jnp.asarray(z), jk, jnp.asarray(n),
                                         jnp.asarray(kind_ix)))
    got = cloud.round_batch(t(z), tk, t(n, torch.int32),
                            t(kind_ix, torch.int32)).numpy()
    assert np.array_equal(want, got)


def test_rounding_keeps_marginals():
    """E[1_S] = z̃ over many keys (the property the regret proof rests on)."""
    z = np.float32([0.3, 0.7, 0.5, 0.5, 1.0, 0.0, 0.25, 0.75, 0.0])
    keys = prng.split(prng.PRNGKey(0, "cpu"), 4000)
    masks = rounding.pairwise_round_batch(t(z).expand(4000, 9), keys).numpy()
    np.testing.assert_allclose(masks.mean(0), z, atol=0.03)
    assert np.allclose(masks.sum(1), z.sum())
