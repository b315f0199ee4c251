"""The port's partition matroid (`repro_torch.core.partition`, paper App.
C.1) against the JAX package, on the CPU.

`lp_partition` is held to the reference's z̃ within 1e-5 and to the LP's
feasibility (the reference's own checks, `tests/test_partition.py`); the
partition policy picks the reference's masks on the per-decision corpus
(`test_torch_fleet._corpus`) with the reference's groups and caps; the
numpy rounding and the enumeration are copies and give the same arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpm
from repro.env.llm_profiles import paper_pool as jpaper_pool
from repro_torch import convert
from repro_torch.core import partition as pm
from test_torch_fleet import _corpus

torch.set_num_threads(1)
GROUPS = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2])
CAPS = np.array([2, 1, 2])


def make_instance(seed):
    """`tests/test_partition.py`'s instances: 2–3 groups of 1–3 arms."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 4))
    sizes = rng.integers(1, 4, m)
    k = int(sizes.sum())
    groups = np.repeat(np.arange(m), sizes)
    caps = np.array([int(rng.integers(1, s + 1)) for s in sizes])
    mu = rng.uniform(0.05, 0.95, k)
    c = rng.uniform(0.01, 0.5, k)
    rho = float(c.sum() * rng.uniform(0.3, 0.9))
    return groups, caps, mu, c, rho


_JLP = jax.jit(jpm.lp_partition, static_argnames=("drop_negative",))


@pytest.mark.parametrize("drop_negative", [True, False])
def test_lp_partition_matches_and_is_feasible(drop_negative):
    """With ``drop_negative`` False (AIC's log weights) every cap fills, so
    the budget may be unattainable: the reference then returns its λ-cap
    vertex, and only the match is held."""
    for seed in range(16):
        groups, caps, mu, c, rho = make_instance(seed)
        w = mu if drop_negative else np.log(mu)
        want = np.asarray(_JLP(
            jnp.asarray(w, jnp.float32), jnp.asarray(c, jnp.float32),
            jnp.asarray(groups), jnp.asarray(caps), jnp.float32(rho),
            drop_negative=drop_negative))
        z = pm.lp_partition(torch.tensor(w, dtype=torch.float32),
                            torch.tensor(c, dtype=torch.float32), groups,
                            caps, rho, drop_negative).numpy()
        np.testing.assert_allclose(z, want, atol=1e-5, rtol=0)
        assert np.all(z >= -1e-6) and np.all(z <= 1 + 1e-6)
        for g in np.unique(groups):
            assert z[groups == g].sum() <= caps[g] + 1e-4
        if drop_negative:        # the LP dominates the best feasible action
            assert float(np.dot(c, z)) <= rho * 1.002 + 1e-5
            actions = pm.enumerate_partition_actions(len(mu), groups, caps)
            vals = np.where(actions @ c <= rho + 1e-9, actions @ mu, -np.inf)
            assert float(np.dot(mu, z)) >= vals.max() - 1e-3


def test_lp_partition_rows_equal_single_rows():
    groups, caps, mu, c, rho = make_instance(3)
    rng = np.random.default_rng(1)
    w = rng.uniform(0.05, 0.95, (5, len(mu))).astype(np.float32)
    rows = pm.lp_partition(torch.tensor(w), torch.tensor(c), groups, caps,
                           rho).numpy()
    for i in range(5):
        one = pm.lp_partition(torch.tensor(w[i]), torch.tensor(c), groups,
                              caps, rho).numpy()
        assert np.array_equal(rows[i], one)


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_partition_policy_matches_on_the_corpus(kind):
    pool = jpaper_pool("sciq")
    stats, ts, keys = _corpus(pool)
    act = jpm.make_partition_policy(kind, 9, GROUPS, CAPS, rho=0.6,
                                    delta=0.1)
    want = np.asarray(jax.jit(jax.vmap(act))(
        {k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(keys),
        jnp.asarray(ts)))
    got = pm.make_partition_policy(kind, 9, GROUPS, CAPS, rho=0.6, delta=0.1,
                                   device="cpu")(
        {k: torch.tensor(v) for k, v in stats.items()},
        convert.key_rows(keys, "cpu"), torch.tensor(ts)).numpy()
    bad = np.nonzero((want != got).any(-1))[0]
    assert bad.size == 0, bad
    assert set(np.unique(got)) <= {0.0, 1.0}


def test_partition_round_np_and_enumeration_are_copies():
    groups, caps, mu, c, rho = make_instance(5)
    z = pm.lp_partition(torch.tensor(mu, dtype=torch.float32),
                        torch.tensor(c, dtype=torch.float32), groups, caps,
                        rho).double().numpy()
    for seed in range(20):
        want = jpm.partition_round_np(z, groups, np.random.default_rng(seed))
        got = pm.partition_round_np(z, groups, np.random.default_rng(seed))
        assert np.array_equal(want, got)
        for g in np.unique(groups):
            assert got[groups == g].sum() <= caps[g] + 1e-9
    assert np.array_equal(pm.enumerate_partition_actions(9, GROUPS, CAPS),
                          jpm.enumerate_partition_actions(9, GROUPS, CAPS))
