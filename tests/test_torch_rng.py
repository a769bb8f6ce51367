"""raytracer_tpu_torch.core.rng against jax.random, bit for bit.

The port's renders draw the JAX package's samples only if fold_in, split
and uniform agree exactly, so the tolerance is zero (compared as bits).
"""
import jax
import numpy as np
import pytest

from raytracer_tpu_torch.core import rng

SEEDS = [0, 1, 7, 123456789, -3]


def _words(k):
    return (k.k1, k.k2)


@pytest.mark.parametrize('seed', SEEDS)
def test_prng_key_and_fold_in(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    assert tuple(np.asarray(kj).tolist()) == _words(kt)
    for data in (0, 5, 2 ** 31 + 11):
        kj2 = jax.random.fold_in(kj, data)
        assert tuple(np.asarray(kj2).tolist()) == _words(rng.fold_in(kt, data))


@pytest.mark.parametrize('seed', SEEDS)
def test_split_six(seed):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = rng.fold_in(rng.PRNGKey(seed), 3)
    got = [_words(k) for k in rng.split(kt, 6)]
    want = [tuple(r) for r in np.asarray(jax.random.split(kj, 6)).tolist()]
    assert got == want
    assert [_words(k) for k in rng.split(kt)] == \
        [tuple(r) for r in np.asarray(jax.random.split(kj)).tolist()]


@pytest.mark.parametrize('shape', [(1000, 3), (4, 257, 2), (1, 5)])
def test_uniform_bits(shape):
    kj, kt = jax.random.PRNGKey(42), rng.PRNGKey(42)
    for step in range(3):
        kj2, kt2 = jax.random.fold_in(kj, step), rng.fold_in(kt, step)
        uj = np.asarray(jax.random.uniform(kj2, shape))
        ut = rng.uniform(kt2, shape).numpy()
        assert ut.shape == uj.shape and ut.dtype == np.float32
        np.testing.assert_array_equal(ut.view(np.uint32), uj.view(np.uint32))
        assert ut.min() >= 0.0 and ut.max() < 1.0
