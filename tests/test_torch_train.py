"""The trainer in the port against the JAX package's, on the CPU.

* `refresh_clusters` and `refresh_iclusters` of perturbed vertices against
  the JAX functions: the tables made of gathers, subtractions and min/max
  (the MT basis, the cluster boxes, `pbb`) byte-equal; the instance and
  segment world boxes, which go through a 3x4 transform whose sums XLA may
  fuse, within rtol 1e-6.
* `loss_and_grads_scanned` against the JAX function on the same perturbed
  parameters, target and key: the loss within rtol 1e-5 and every leaf
  within rtol 1e-3 and atol 1e-4 x max|leaf| (both sum the same float32
  terms, in other orders: the vertex gradients are scatter sums). Cases:
  `triangle_sphere` 8x8 with a 48-ray tile (padding lanes), 12-sphere
  `sponza_standin` 32x24 with 3 bounces, `instanced_teapots_standin`
  32x24 (the two-level refresh) and a 4x4-texel quad (texel gradients).
  The parameters are perturbed (vertices by 1e-3, kd by -10%) and the
  target is random, except on `sponza_standin`, which keeps bench.py's
  zero target and the built parameters: with two GI bounces, a few paths
  there start their last bounce from a cosine sample whose sin/cos differ
  in the last ulp between the two libraries and take another path, which
  moves a few vertex gradients, summed over many pixels of either sign,
  by up to a few percent (ROADMAP queue 3, not a fault).
* One `train_step` against optax's Adam on the same gradients: parameters
  within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.geometry import clusters as jcl
from raytracer_tpu.parallel import sharding as js
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core.types import Camera, RenderSettings
from raytracer_tpu_torch.geometry import clusters as tcl
from raytracer_tpu_torch.geometry import shapes
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, jax_camera, jax_settings, to_port

KEY = 3


def _perturbed_vertices(verts, seed, scale=2e-3):
    rs = np.random.default_rng(seed)
    v = np.asarray(verts, np.float32)
    return (v + rs.normal(size=v.shape) * scale).astype(np.float32)


def _geoms(sj, sp, seed):
    """The JAX and port geometries with the same perturbed vertices (both
    poses shifted alike, as apply_params does)."""
    v0 = np.asarray(sj.geom.vertices)
    v = _perturbed_vertices(v0, seed)
    v1 = np.asarray(sj.geom.vertices_t1) + (v - v0)
    gj = sj.geom.replace(vertices=jnp.asarray(v), vertices_t1=jnp.asarray(v1))
    gp = dataclasses.replace(sp.geom, vertices=torch.from_numpy(v),
                             vertices_t1=torch.from_numpy(v1))
    return gj, gp


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('name', ['triangle_sphere', 'mb_bullet'])
def test_refresh_clusters_matches_jax(name):
    make = dict(triangle_sphere=registry.triangle_sphere,
                mb_bullet=registry.mb_bullet_standin)[name]
    sj, _, _ = cpu(make, 8, builder=rj.SceneBuilder())
    sp = to_port(sj)
    gj, gp = _geoms(sj, sp, seed=1)
    mb = sj.has_motion_blur
    want = jcl.refresh_clusters(sj.clusters, gj, mb)
    got = tcl.refresh_clusters(sp.clusters, gp, mb)
    for f in ('bb_min', 'bb_max', 'p0', 'e1', 'e2', 'p0_t1', 'e1_t1',
              'e2_t1', 'tri'):
        _equal(getattr(got, f), getattr(want, f))
    assert (got.p0_t1 is got.p0) == (not mb)
    # the refresh moved the table: it is not the build's
    assert not torch.equal(got.p0, sp.clusters.p0)


@pytest.mark.parametrize('name', ['instanced_teapots', 'final_forest'])
def test_refresh_iclusters_matches_jax(name):
    if name == 'instanced_teapots':
        sj, _, _ = cpu(registry.instanced_teapots_standin, 16, 16,
                       builder=rj.SceneBuilder(), bvh=True)
    else:
        sj, _, _ = cpu(registry.final_forest_standin, 16, 16, n_trees=2,
                       n_flowers=6, grass_grid=4, builder=rj.SceneBuilder(),
                       bvh=True)
    sp = to_port(sj)
    gj, gp = _geoms(sj, sp, seed=2)
    want = jcl.refresh_iclusters(sj.iclusters, gj, sj.instances)
    got = tcl.refresh_iclusters(sp.iclusters, gp, sp.instances)
    for f in ('p0', 'e1', 'e2', 'pbb', 'tri'):
        _equal(getattr(got, f), getattr(want, f))
    for f in ('ibb', 'sbb'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    assert not torch.equal(got.sbb, sp.iclusters.sbb)
    if sj.mb_clusters is not None:     # the partition refreshes as mb
        want = jcl.refresh_clusters(sj.mb_clusters, gj, True)
        got = tcl.refresh_clusters(sp.mb_clusters, gp, True)
        for f in ('bb_min', 'bb_max', 'p0', 'e2_t1'):
            _equal(getattr(got, f), getattr(want, f))


def _textured_quad(builder):
    rs = np.random.default_rng(7)
    tex = builder.add_texture(rs.uniform(0.2, 0.8, (4, 4, 3))
                              .astype(np.float32))
    m = builder.add_blinn(kd=(1, 1, 1), tex_color=tex)
    builder.add_mesh(shapes.quad((-2, 0, -2), (2, 0, -2), (2, 0, 2),
                                 (-2, 0, 2)), m)
    builder.add_point_light((2, 5, 2), 400.0)
    return builder.build(bvh=False)


def _case(name):
    """(JAX scene, port scene, port camera, settings, tile, JAX
    intersector)."""
    if name == 'triangle_sphere':
        sj, cam, st = cpu(registry.triangle_sphere, size=8,
                          builder=rj.SceneBuilder())
        return sj, cam, st, 48, 'brute'
    if name == 'sponza_12':
        sj, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                          n_spheres=12, builder=rj.SceneBuilder())
        return sj, cam, st, st.ray_tile, 'cluster_pallas'
    if name == 'instanced_teapots':
        sj, cam, st = cpu(registry.instanced_teapots_standin, 32, 24,
                          builder=rj.SceneBuilder(), bvh=True)
        return sj, cam, st, st.ray_tile, 'cluster2'
    sj = _textured_quad(rj.SceneBuilder())
    cam = Camera.make(eye=(0, 4, 4), look_at=(0, 0, 0), fov=45.0)
    st = RenderSettings(width=8, height=8, path_trace=False,
                        max_wavefront_steps=2)
    return sj, cam, st, st.ray_tile, 'brute'


@pytest.mark.parametrize('name', ['triangle_sphere', 'sponza_12',
                                  'instanced_teapots', 'textured_quad'])
def test_loss_and_grads_match_jax(name):
    sj, cam, st, tile, jmode = _case(name)
    sp = to_port(sj)
    pj = {k: np.asarray(v) for k, v in js.get_params(sj).items()}
    rs = np.random.default_rng(4)
    target = rs.uniform(0, 0.5, (st.height, st.width, 3)).astype(np.float32)
    if name == 'sponza_12':
        target[:] = 0.0
    else:
        pj['vertices'] = _perturbed_vertices(pj['vertices'], seed=3,
                                             scale=1e-3)
        pj['kd'] = (pj['kd'] * 0.9).astype(np.float32)
    lj, gj = js.loss_and_grads_scanned(
        {k: jnp.asarray(v) for k, v in pj.items()}, sj, jax_camera(cam),
        jax_settings(st, intersector=jmode), jnp.asarray(target),
        jax.random.PRNGKey(KEY), spp=1, tile=tile)
    params = cpu(convert.params_from_arrays, pj)
    lt, gt = ts.loss_and_grads_scanned(params, sp, cam, st,
                                       torch.from_numpy(target),
                                       rng.PRNGKey(KEY), spp=1, tile=tile)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert set(gt) == set(ts.PARAM_KEYS)
    for k in ts.PARAM_KEYS:
        got, want = gt[k].numpy(), np.asarray(gj[k])
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    assert np.abs(gt['vertices'].numpy()).max() > 0
    # the texture stands in for kd on the quad
    leaf = 'tex_data' if name == 'textured_quad' else 'kd'
    assert np.abs(gt[leaf].numpy()).max() > 0
    # the parameters were not touched
    assert np.array_equal(params['vertices'].numpy(), pj['vertices'])


def test_train_step_matches_optax_adam():
    sp, cam, st = cpu(registry.triangle_sphere, size=8)
    params = ts.get_params(sp)
    target = torch.zeros((8, 8, 3))
    key = rng.PRNGKey(KEY)
    loss, grads = ts.loss_and_grads_scanned(params, sp, cam, st, target, key)
    start = convert.params_to_arrays(params)
    opt = optax.adam(0.01)
    state = opt.init({k: jnp.asarray(v) for k, v in start.items()})
    updates, _ = opt.update({k: jnp.asarray(g.numpy())
                             for k, g in grads.items()}, state)
    want = optax.apply_updates({k: jnp.asarray(v) for k, v in start.items()},
                               updates)
    new, loss2 = ts.train_step(params, ts.make_optimizer(params, lr=0.01), sp,
                               cam, st, target, key)
    assert float(loss2) == float(loss)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert not np.array_equal(new['vertices'].numpy(), start['vertices'])


def test_params_round_trip_and_mesh_raises():
    sp, cam, st = cpu(registry.triangle_sphere, size=8)
    params = ts.get_params(sp)
    again = cpu(convert.params_from_arrays, convert.params_to_arrays(params))
    for k in ts.PARAM_KEYS:
        assert torch.equal(again[k], params[k])
    assert params['vertices'] is not sp.geom.vertices
    # a mesh is parallel.distributed.Mesh (sharding.make_mesh) or nothing
    with pytest.raises(TypeError, match='distributed.Mesh'):
        ts.loss_and_grads_scanned(params, sp, cam, st, torch.zeros(8, 8, 3),
                                  rng.PRNGKey(0), mesh=object())
    assert ts.loss_and_grads_streamed is ts.loss_and_grads_scanned


def test_apply_params_refresh_moves_the_hits():
    """Moved vertices reach the tracer only through the refresh: without
    it the tables (and so the traced hits) stay those of the build."""
    sp, cam, st = cpu(registry.triangle_sphere, size=8)
    params = ts.get_params(sp)
    params['vertices'] = params['vertices'] + torch.tensor([0.0, 0.25, 0.0])
    moved = ts.apply_params(sp, params)
    stale = ts.apply_params(sp, params, refresh=False)
    assert stale.clusters is sp.clusters
    assert not torch.equal(moved.clusters.p0, sp.clusters.p0)
    px, py = cam_mod.pixel_coords(st.width, st.height)
    render = lambda s: ts._render_local(s, cam, st, 1, px, py,
                                        rng.PRNGKey(1))
    assert not torch.equal(render(moved), render(stale))


def test_grads_finite_at_normal_incidence_and_parallel_misses():
    """Two rays meet a Blinn quad exactly head-on (the Fresnel term's
    sqrt(1 - cos^2) at 0) and one misses it in its plane (refine_hit's
    recompute against the clamped id 0 has det == 0). Each used to turn
    every vertex gradient NaN through the 0 * inf of a branch a `where`
    drops, as it still does in the JAX package; the port's gradients are
    finite."""
    from raytracer_tpu_torch import SceneBuilder
    from raytracer_tpu_torch.render import integrator
    b = SceneBuilder()
    m = b.add_blinn(kd=(0.8, 0.8, 0.8))
    b.add_mesh(shapes.quad((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0),
                           with_uv=False), m)
    b.add_point_light((0.5, 0.5, 3), 100.0)
    scene = b.build(device='cpu')
    st = RenderSettings(width=3, height=1, path_trace=False,
                        max_wavefront_steps=2, sort_rays=False)
    params = ts.get_params(scene)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    s = ts.apply_params(scene, leaves)
    o = torch.tensor([[0.1, 0.2, 5.0], [0.3, -0.4, 5.0], [5.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    L = integrator.radiance(s, st, o, d, 0.0, rng.PRNGKey(0))
    assert float(L[:2].min()) > 0 and float(L[2].abs().max()) == 0
    L.sum().backward()
    g = leaves['vertices'].grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert bool(torch.isfinite(leaves['kd'].grad).all())
