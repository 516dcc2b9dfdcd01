"""The port's threefry streams against ``jax.random``, bit for bit.

Every random number of the reference comes from ``jax.random`` (threefry,
partitionable mode); the port reproduces the same words from the same key,
so whole answers can be compared byte for byte. Each draw is checked over
20 seeds and the shapes the walkers use (empty, one, odd, 2-D).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, prng

SEEDS = [0, 1, 2, 3, 5, 7, 11, 42, 99, 123, 1000, 4242, 65535, 65536,
         2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1, -12345]
SHAPES = [(0,), (1,), (7,), (3, 5)]


def _jk(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    kj, kt = _pair(seed)
    assert (_jk(kj) == kt.numpy()).all()
    for num in (2, 3, 7):
        assert (_jk(jax.random.split(kj, num))
                == prng.split(kt, num).numpy()).all()
    for data in (0, 1, 17, 2**31 - 1):
        assert (_jk(jax.random.fold_in(kj, data))
                == prng.fold_in(kt, data).numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed):
    kj, kt = _pair(seed)
    for shape in SHAPES:
        got = prng.random_bits(kt, shape).numpy()
        want = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
        assert got.shape == want.shape
        assert (got == want.astype(np.int64)).all()
        for hi in (1 << 30, 1, 7, 500, 65536, 65537, 100_000):
            want = np.asarray(jax.random.randint(kj, shape, 0, hi,
                                                 jnp.int32))
            got = prng.randint(kt, shape, 0, hi).numpy()
            assert got.dtype == np.int32
            assert (got == want).all(), (shape, hi)
        want = np.asarray(jax.random.uniform(kj, shape))
        got = prng.uniform(kt, shape).numpy()
        assert got.dtype == want.dtype == np.float32
        assert (got.view(np.int32) == want.view(np.int32)).all()
        want = np.asarray(jax.random.bernoulli(kj, 0.15, shape))
        got = prng.bernoulli(kt, 0.15, shape).numpy()
        assert (got == want).all()


def test_per_element_fold_in_and_batched_draws():
    """The walk index's streams: ``fold_in(fold_in(key, v), l)`` per vertex
    (a ``vmap`` in the reference), then ``randint`` at shape ``(R,)`` from
    each row key."""
    key = jax.random.PRNGKey(9)
    vs = jnp.arange(37, dtype=jnp.int32) * 13
    rows_j = jax.vmap(lambda v: jax.random.fold_in(key, v))(vs)
    kt = prng.PRNGKey(9, "cpu")
    rows_t = prng.fold_in(kt, torch.arange(37, dtype=torch.int32) * 13)
    assert (_jk(rows_j) == rows_t.numpy()).all()
    for step in range(3):
        ks_j = jax.vmap(lambda kk: jax.random.fold_in(kk, step))(rows_j)
        ks_t = prng.fold_in(rows_t, step)
        assert (_jk(ks_j) == ks_t.numpy()).all()
        want = np.asarray(jax.vmap(lambda kk: jax.random.randint(
            kk, (8,), 0, 1 << 30, jnp.int32))(ks_j))
        assert (prng.randint(ks_t, (8,), 0, 1 << 30).numpy() == want).all()


def test_key_chain_like_the_scheduler():
    """Fifty waves of ``key, k_wave = split(key)`` stay in lockstep."""
    kj, kt = _pair(3)
    for _ in range(50):
        kj, wj = jax.random.split(kj)
        kt, wt = prng.split(kt)
        assert (_jk(wj) == wt.numpy()).all()


def test_key_data_round_trip_and_validation():
    kj = jax.random.fold_in(jax.random.PRNGKey(4), 77)
    kt = convert.key_from_jax(jax.random.key_data(kj), device="cpu")
    assert (prng.key_data(kt).numpy() == _jk(kj)).all()
    assert torch.equal(prng.wrap_key_data(prng.key_data(kt)), kt)
    with pytest.raises(ValueError):
        prng.wrap_key_data([1, 2, 3], "cpu")
    with pytest.raises(ValueError):
        prng.wrap_key_data([-1, 2], "cpu")
    with pytest.raises(TypeError):
        prng.split(torch.zeros(2, dtype=torch.int32))
