"""The port's PRNG (`repro_torch.prng`) against `jax.random`: bit-equal keys
and draws over a grid of seeds, split counts, fold-in data and shapes,
including the batched (M, 2) key rows the fleet carries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 123456789, 2 ** 31 - 1, -5]


def as_np(t):
    return t.numpy().astype(np.uint32)


def test_threefry_partitionable_is_the_configuration():
    """The port reproduces jax_threefry_partitionable=True, threefry2x32."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bit_equal(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          as_np(prng.PRNGKey(seed, "cpu")))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 4, 7])
def test_split_bit_equal(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = as_np(prng.split(prng.PRNGKey(seed, "cpu"), num))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("data", [0, 12345, 2 ** 32 - 1])
def test_fold_in_bit_equal(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(data)))
    got = as_np(prng.fold_in(prng.PRNGKey(seed, "cpu"), data))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("shape", [(), (3,), (4, 9), (2, 3, 5), (1001,)])
def test_bits_bit_equal(shape):
    for seed in (0, 99):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        got = as_np(prng.bits(prng.PRNGKey(seed, "cpu"), shape))
        assert np.array_equal(want, got), (seed, shape)


@pytest.mark.parametrize("shape", [(), (9,), (4, 9), (3, 4, 5)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), ("tiny", 1.0), (-2.0, 3.5)])
def test_uniform_bit_equal(shape, bounds):
    lo, hi = bounds
    if lo == "tiny":
        lo = float(np.finfo(np.float32).tiny)
        jlo = jnp.finfo(jnp.float32).tiny
    else:
        jlo = lo
    for seed in (3, 2024):
        key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
        want = np.asarray(jax.random.uniform(key, shape, minval=jlo,
                                             maxval=hi))
        tkey = prng.split(prng.PRNGKey(seed, "cpu"), 3)[2]
        got = prng.uniform(tkey, shape, minval=lo, maxval=hi).numpy()
        assert want.dtype == got.dtype == np.float32
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32)), \
            (seed, shape, bounds)


def test_batched_key_rows_match_vmap():
    """(M, 2) key rows: split / uniform broadcast over the tenant axis as
    `jax.vmap` over per-row keys does (the fleet's usage)."""
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    tkeys = prng.split(prng.PRNGKey(5, "cpu"), 6)
    want_split = np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(keys))
    assert np.array_equal(want_split, as_np(prng.split(tkeys, 4)))
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (4, 9)))(
        keys))
    assert np.array_equal(want_u, prng.uniform(tkeys, (4, 9)).numpy())
    want_s = np.asarray(jax.vmap(jax.random.uniform)(keys))
    assert np.array_equal(want_s, prng.uniform(tkeys).numpy())


def test_key_chain_stays_bit_equal():
    """A fleet-style chain — split(key, 4) per round, keep the first — stays
    bit-equal over many rounds."""
    key, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11, "cpu")
    for _ in range(50):
        key = jax.random.split(key, 4)[0]
        tkey = prng.split(tkey, 4)[0]
    assert np.array_equal(np.asarray(key), as_np(tkey))


# ================================================ normal, exponential, beta
# `prng` evaluates XLA's erf_inv polynomial and the Marsaglia–Tsang loop
# with every contracted multiply-add and every transcendental rounded once
# from float64; XLA's own float32 log1p and log differ in the last bits
# (module docstring). Measured on these keys: normal 3 ulps, exponential
# 1 ulp, loggamma 3.9e-6 (at a < 1, its boosted branch), beta 1.5e-7.
NORMAL_ULPS, EXPONENTIAL_ULPS = 4, 2
LOGGAMMA_ATOL, BETA_ATOL = 1e-5, 1e-6


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("shape", [(), (9,), (4, 9), (20000,)])
def test_normal_and_exponential_within_ulps(shape):
    for seed in (0, 7, 2024):
        key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
        want = np.asarray(jax.random.normal(key, shape))
        got = prng.normal(tkey, shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert ulps(got, want).max() <= NORMAL_ULPS, seed
        want = np.asarray(jax.random.exponential(key, shape))
        got = prng.exponential(tkey, shape).numpy()
        assert ulps(got, want).max() <= EXPONENTIAL_ULPS, seed
        assert (got >= 0).all()


@pytest.mark.parametrize("regime", ["counts", "small"])
def test_loggamma_and_beta_match_jax(regime):
    """Thompson sampling's draws: Beta(1 + s, 1 + f) over (seeds, arms)
    rows ("counts"), and shapes below 1, which take the boost branch."""
    rng = np.random.default_rng(0 if regime == "counts" else 1)
    shape = (64, 9)
    if regime == "counts":
        t = rng.integers(0, 40, shape)
        a = (1 + t * rng.uniform(0, 1, shape)).astype(np.float32)
        b = (1 + t - (a - 1)).astype(np.float32)
    else:
        a = rng.uniform(0.05, 3, shape).astype(np.float32)
        b = rng.uniform(0.05, 3, shape).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(100), shape[0])
    tkeys = prng.split(prng.PRNGKey(100, "cpu"), shape[0])
    want = np.asarray(jax.jit(jax.vmap(jax.random.loggamma))(keys, a))
    got = prng.loggamma(tkeys, torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGGAMMA_ATOL, rtol=0)
    want = np.asarray(jax.jit(jax.vmap(jax.random.beta))(keys, a, b))
    got = prng.beta(tkeys, torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=BETA_ATOL, rtol=0)
    assert ((got >= 0) & (got <= 1)).all()
    # one key row draws what it draws alone
    one = prng.beta(tkeys[3], torch.tensor(a[3]), torch.tensor(b[3]))
    assert torch.equal(one, torch.tensor(got[3]))
