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
