"""The plain PyTorch cluster tracer against the JAX Pallas kernel (run in
interpret mode off-TPU, its default) and against brute force.

It follows the Pallas kernel's visiting rule, so `tri` must agree exactly
and t within rtol 1e-6 (both sides run the same float32 Moller-Trumbore
arithmetic). Against brute force, which breaks exact ties by triangle id
and not table order, rays must agree wherever brute force hits a unique
triangle; any-hit only on whether a hit exists. The CUDA kernel is held to
this plain version in tests/test_torch_cuda.py, on the card.

Any-hit rays stop at the random target point they aim at (a shadow ray's
light distance). The barycentrics a, b are recomputed from the winning
triangle on each side, by XLA on the JAX side, which may fuse
multiply-adds; at grazing triangles the numerator cancels, so they are
held to atol 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import intersect as jisect
from raytracer_tpu.ops.pallas import cluster_kernel as jck
from raytracer_tpu_torch.core.vecmath import MIRO_TMAX
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, random_rays, to_port

R = 512
SCENES = {
    'triangle_sphere': lambda: cpu(registry.triangle_sphere,
        size=8, builder=rj.SceneBuilder()),
    'sponza_standin_12': lambda: cpu(registry.sponza_standin,
        32, 24, max_bounces=3, n_spheres=12, builder=rj.SceneBuilder()),
}


@pytest.fixture(scope='module', params=sorted(SCENES))
def scenes(request):
    sj, cam, _ = SCENES[request.param]()
    return sj, to_port(sj), cam


def _rays(scene, cam, kind):
    """Incoherent random rays, or coherent camera rays (16 x 32)
    -> (o, d, time, any-hit distance)."""
    if kind == 'random':
        cl = scene.clusters
        return random_rays(cl.bb_min, cl.bb_max, cl.tri, R, seed=5)
    o, d, t = tcam.center_rays(cam, 32, 16)
    dist = np.random.default_rng(6).uniform(1.0, 8.0, R).astype(np.float32)
    return o.numpy(), d.numpy(), np.zeros(R, np.float32), dist


@pytest.mark.parametrize('kind', ['random', 'camera'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_plain_matches_pallas(scenes, kind, any_hit):
    sj, st, cam = scenes
    o, d, time, dist = _rays(st, cam, kind)
    tmax = dist.copy() if any_hit else np.full(R, 1e12, np.float32)
    tmax[::7] = -1.0                     # dead lanes, as the integrator sends
    hj = jck.pallas_cluster_trace(sj, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(time), 1e-3, jnp.asarray(tmax),
                                  any_hit, rb=32)
    ht = ct.cluster_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(time), 1e-3,
                          torch.from_numpy(tmax), any_hit)
    tri_j = np.asarray(hj.tri)
    np.testing.assert_array_equal(ht.tri.numpy(), tri_j)
    assert (tri_j >= 0).sum() > R // 10, 'too few hits to test anything'
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=1e-6)
    np.testing.assert_allclose(ht.a.numpy(), np.asarray(hj.a), atol=2e-5)
    np.testing.assert_allclose(ht.b.numpy(), np.asarray(hj.b), atol=2e-5)


@pytest.mark.parametrize('any_hit', [False, True])
def test_plain_matches_brute(scenes, any_hit):
    sj, st, cam = scenes
    o, d, time, dist = _rays(st, cam, 'random')
    tmax = dist if any_hit else np.full(R, 1e12, np.float32)
    hb = jisect.brute_force_trace(sj, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(time), 1e-3, jnp.asarray(tmax),
                                  False)
    tmax = torch.from_numpy(tmax)
    hbt = tisect.brute_force_trace(st, torch.from_numpy(o),
                                   torch.from_numpy(d), torch.from_numpy(time),
                                   1e-3, tmax, False)
    np.testing.assert_array_equal(hbt.tri.numpy(), np.asarray(hb.tri))
    ht = ct.cluster_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(time), 1e-3, tmax, any_hit)
    tri_b = np.asarray(hb.tri)
    if any_hit:
        np.testing.assert_array_equal(ht.tri.numpy() >= 0, tri_b >= 0)
        return
    same = ht.tri.numpy() == tri_b
    # a mismatch is only allowed at an exact tie in t
    np.testing.assert_array_equal(ht.t.numpy()[~same],
                                  np.asarray(hb.t)[~same])
    assert same.mean() > 0.99
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hb.t), rtol=1e-6)


def test_plain_miss_and_dead_rays(scenes):
    _, st, cam = scenes
    o, d, time, _ = _rays(st, cam, 'camera')
    tmax = torch.full((R,), -1.0)
    h = ct.cluster_trace(st, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                         1e-3, tmax, False)
    assert (h.tri == -1).all() and (h.t == np.float32(MIRO_TMAX)).all()
    assert (h.a == 0).all() and (h.b == 0).all()
