"""The port's procedural textures (shading/procedural.py) against the JAX
package's, on the CPU.

Perlin noise keeps the invariants of the JAX package's reference-value
test (tests/test_features.py: zero at lattice points, within [-1, 1], not
flat) and matches jnp within 1e-5 on the same float32 inputs; so do
`stone_lookup` on random texture coords and the bakes. The cell centres
come from the same numpy generator, so they are equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.shading import procedural as jp
from raytracer_tpu_torch.shading import procedural as tp


def test_perlin_reference_values():
    assert abs(float(tp.perlin_noise(0.0, 0.0, 0.0))) < 1e-6
    x = np.linspace(0, 10, 1000, dtype=np.float32)
    y = np.linspace(0, 7, 1000, dtype=np.float32)
    z = np.full(1000, 0.5, np.float32)
    n = tp.perlin_noise(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(z)).numpy()
    assert np.isfinite(n).all()
    assert n.min() >= -1.0 and n.max() <= 1.0
    assert n.std() > 0.05
    want = np.asarray(jp.perlin_noise(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(z)))
    np.testing.assert_allclose(n, want, rtol=0, atol=1e-5)


def test_perlin_matches_jax_on_random_points():
    rs = np.random.default_rng(0)
    pts = rs.uniform(-300, 300, (3, 4096)).astype(np.float32)
    got = tp.perlin_noise(*(torch.from_numpy(p) for p in pts)).numpy()
    want = np.asarray(jp.perlin_noise(*(jnp.asarray(p) for p in pts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stone_cells_equal():
    pj, mnj, mxj = jp.make_stone_cells(20, seed=5)
    pt, mnt, mxt = tp.make_stone_cells(20, seed=5)
    np.testing.assert_array_equal(pt, pj)
    assert (mnt, mxt) == (mnj, mxj)


def test_stone_lookup_matches_jax():
    cells, mn, mx = jp.make_stone_cells(30)
    rs = np.random.default_rng(1)
    u, v = rs.uniform(-2, 2, (2, 2000)).astype(np.float32)
    got = tp.stone_lookup(torch.from_numpy(u), torch.from_numpy(v),
                          torch.from_numpy(cells), mn, mx, 30).numpy()
    want = np.asarray(jp.stone_lookup(jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(cells), mn, mx, 30))
    assert got.shape == (2000, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('num_cells,size', [(20, 64), (100, 48)])
def test_bake_stone_texture_matches_jax(num_cells, size):
    got = tp.bake_stone_texture(num_cells=num_cells, size=size,
                                device='cpu')
    want = jp.bake_stone_texture(num_cells=num_cells, size=size)
    assert isinstance(got, torch.Tensor) and got.shape == (size, size, 3)
    assert got.dtype == torch.float32 and got.device.type == 'cpu'
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # stone and grout both present
    assert float(got.std()) > 0.05


def test_bake_perlin_texture_matches_jax():
    got = tp.bake_perlin_texture(size=32, device='cpu')
    want = jp.bake_perlin_texture(size=32)
    assert got.shape == (32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
