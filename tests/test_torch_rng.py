"""raytracer_tpu_torch.core.rng against jax.random, bit for bit.

The port's renders draw the JAX package's samples only if fold_in, split,
uniform and randint agree exactly, with single keys and with batches of
keys, so the tolerance is zero (compared as bits). These run the plain
version (the CPU's); tests/test_torch_cuda.py holds the card's threefry
kernel to it bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops.cuda import rng_kernel

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


# spans of diff/edges.gi_edge_vertex_grad's pixel draws (W * H, most not
# powers of two), both sides of 2**16 (above it jax's multiplier wraps
# to 0), a power of two, a shifted range and an empty one
RANGES = [(0, 32 * 32), (0, 64 * 48), (0, 1920 * 1080), (0, 1000),
          (0, 65536), (0, 65537), (0, 1 << 20), (-7, 12), (-10, 2 ** 31 - 1),
          (5, 5)]


@pytest.mark.parametrize('lo,hi', RANGES)
def test_randint_bits(lo, hi):
    for seed in (0, 7, -3):
        for data in (0, 0x61ed):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), data)
            kt = rng.fold_in(rng.PRNGKey(seed), data)
            want = np.asarray(jax.random.randint(kj, (4099,), lo, hi))
            got = rng.randint(kt, (4099,), lo, hi).numpy()
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    assert got.min() >= lo and (got.max() < hi or lo == hi)


def test_tensor_keys_fold_in_and_uniform():
    """jax.vmap(fold_in, (None, 0))(k, ids) and uniform(k, (5,)) per key,
    as render_adaptive draws its per-pixel jitter, from a batch of keys."""
    ids = np.arange(0, 3000, 3, dtype=np.int32)
    kj = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    keys_j = jax.vmap(jax.random.fold_in, (None, 0))(kj, jnp.asarray(ids))
    u_j = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5,)))(keys_j))
    keys = rng.fold_in(rng.fold_in(rng.PRNGKey(9), 4), torch.from_numpy(ids))
    assert keys.k1.shape == (1000,) and keys.k1.dtype == torch.int64
    np.testing.assert_array_equal(
        np.stack([keys.k1.numpy(), keys.k2.numpy()], -1),
        np.asarray(keys_j).astype(np.int64))
    u = rng.uniform(keys, (5,)).numpy()
    assert u.shape == (1000, 5)
    np.testing.assert_array_equal(u.view(np.uint32), u_j.view(np.uint32))
    # the int path is the tensor path at one key
    one = rng.fold_in(rng.fold_in(rng.PRNGKey(9), 4), int(ids[7]))
    np.testing.assert_array_equal(rng.uniform(one, (5,)).numpy(), u[7])


# the wavefront draws of render/integrator._step ((R, k) in runs along
# axis 0) and of the lights' NEE ((num_samples, R, 2) along axis 1), and
# a segment that is the whole axis
SEGMENTED = [((12, 3), 4, 0), ((1024, 2), 256, 0), ((12, 3), 12, 0),
             ((1, 40, 2), 8, 1), ((2, 96, 2), 32, 1), ((3, 21, 5), 7, 1)]


@pytest.mark.parametrize('shape,segment,axis', SEGMENTED)
def test_uniform_segmented_is_one_segment_tiled(shape, segment, axis,
                                                monkeypatch):
    """Each run of `segment` rows draws what jax.random.uniform of one
    segment draws, from counters computed from each output's index (no
    copy: Tensor.repeat is not called)."""
    one = list(shape)
    one[axis] = segment
    reps = [1] * len(shape)
    reps[axis] = shape[axis] // segment
    kj = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    want = np.tile(np.asarray(jax.random.uniform(kj, tuple(one))), reps)

    def no_repeat(*a, **k):
        raise AssertionError('uniform_segmented copied with repeat')
    monkeypatch.setattr(torch.Tensor, 'repeat', no_repeat)
    got = rng.uniform_segmented(rng.fold_in(rng.PRNGKey(5), 2), shape,
                                segment, axis).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_segmented_refuses_a_partial_run():
    with pytest.raises(ValueError, match='runs of 4'):
        rng.uniform_segmented(rng.PRNGKey(0), (10, 3), 4, 0)


@pytest.mark.parametrize('n', [1, 3, 5, 17, 1025])
def test_random_bits_and_randint_odd_sizes(n):
    """jax.random.bits and randint at sizes that fill no whole vector of
    the kernel's four outputs a thread (1, 3, 2^k + 1)."""
    for seed in (0, -3):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
        kt = rng.fold_in(rng.PRNGKey(seed), 9)
        want = np.asarray(jax.random.bits(kj, (n,))).astype(np.int64)
        got = rng.random_bits(kt, (n,))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax.random.randint(kj, (n,), -5, 1000))
        np.testing.assert_array_equal(rng.randint(kt, (n,), -5, 1000).numpy(),
                                      want)


def test_tensor_keys_split_fold_in_and_bits():
    """A batch of keys, as jax.vmap sees it: split, fold_in of an int and
    random_bits per key; fold_in of int32 data with negative words."""
    ids = np.array([0, 1, 2, 5, 2 ** 31 - 1, -1, -7], dtype=np.int32)
    kj = jax.random.PRNGKey(11)
    keys_j = jax.vmap(jax.random.fold_in, (None, 0))(kj, jnp.asarray(ids))
    keys = rng.fold_in(rng.PRNGKey(11), torch.from_numpy(ids))

    def words(k):
        return np.stack([k.k1.numpy(), k.k2.numpy()], -1)
    np.testing.assert_array_equal(words(keys),
                                  np.asarray(keys_j).astype(np.int64))
    split_j = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys_j))
    for i, k in enumerate(rng.split(keys, 3)):
        np.testing.assert_array_equal(words(k), split_j[:, i].astype(np.int64))
    folded_j = jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys_j)
    np.testing.assert_array_equal(words(rng.fold_in(keys, 7)),
                                  np.asarray(folded_j).astype(np.int64))
    bits_j = jax.vmap(lambda k: jax.random.bits(k, (3,)))(keys_j)
    np.testing.assert_array_equal(rng.random_bits(keys, (3,)).numpy(),
                                  np.asarray(bits_j).astype(np.int64))


def test_kernel_wrapper_takes_only_the_card():
    """The CPU runs the plain version; the kernel's wrapper refuses any
    device but a CUDA one, and core/rng refuses devices it has no version
    for."""
    with pytest.raises(ValueError, match='not a CUDA device'):
        rng_kernel.draw(1, 2, (3,), 'cpu')
    with pytest.raises(ValueError, match='not a CUDA device'):
        rng_kernel.pair(1, 2, torch.arange(3))
    with pytest.raises(ValueError, match='unsupported device'):
        rng.uniform(rng.PRNGKey(0), (3,), 'meta')
    before = rng_kernel.LAUNCHES
    rng.uniform(rng.PRNGKey(0), (3,), 'cpu')
    assert rng_kernel.LAUNCHES == before
