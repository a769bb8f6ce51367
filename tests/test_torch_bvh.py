"""The port's wide BVH and its plain tracer against the JAX package's.

Both builders build the same scenes with bvh=True: the merged node pool
(the native BLAS build, the Python TLAS build), the stack depth, the entry
node and the instances' BLAS roots must be byte-equal, for a single-level
scene, two-level scenes with a TLAS (a 3,000-instance grid among them),
motion blur, alpha maps, a motion-blurred prototype (which leaves both
scenes without cluster tables) and a scene of duplicated triangles.

Then ops/traverse.bvh_trace against raytracer_tpu.ops.traverse.bvh_trace
on the same rays (numpy, from a seed): the same tri and inst for every ray
and t within rtol 1e-5 (nearest), hit or miss alike (any-hit), and equal
box and triangle test counters (collect_stats). The duplicated triangles
force exact ties in t within a leaf and across leaves, which the visiting
rule decides. A 'bvh' render is held to the JAX package's under the rule
of tests/test_torch_render.py. The JAX traces compile once per scene and
mode (module-scoped fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import traverse as jtr
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch import RenderSettings
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import traverse as ttr
from raytracer_tpu_torch.render import integrator as tint
from raytracer_tpu_torch.scenes import registry

from .test_torch_render import _assert_images_close
from .torch_port_util import (cpu, filled_scene, jax_camera, jax_settings,
                              ray_bounds, scene_rays, tie_scene, to_port)

R = 384


SCENES = {
    'triangle_sphere': (registry.triangle_sphere, dict(size=8)),
    'sponza_12': (registry.sponza_standin, dict(
        width=32, height=24, max_bounces=3, n_spheres=12)),
    'teapots': (registry.instanced_teapots_standin, dict(width=8, height=8)),
    'mb_bullet': (registry.mb_bullet_standin, dict(size=8)),
    'alpha_leaf': (registry.alpha_leaf_standin, dict(size=8)),
    'mb_proto': (registry.mb_prototype_standin, dict(size=8, grid=2, rings=6,
                                                     segs=10)),
    'ties': (filled_scene, dict(fill=tie_scene)),
}


def _pair(name):
    make, kw = SCENES[name]
    sj = cpu(make, builder=rj.SceneBuilder(), bvh=True, **kw)[0]
    sp = cpu(make, bvh=True, **kw)[0]
    return sj, sp


@pytest.fixture(scope='module', params=sorted(SCENES))
def pair(request):
    return (request.param,) + _pair(request.param)


def _assert_bvh_equal(sj, sp):
    for f in ('node_min', 'node_max', 'child', 'count', 'prim_order'):
        a, b = np.asarray(getattr(sj.blas, f)), getattr(sp.blas, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert sp.blas.depth == sj.blas.depth and sp.bvh_root == sj.bvh_root
    for f in ('m', 'm_inv', 'm_inv_t', 'root', 'tri_lo', 'tri_hi'):
        a = np.asarray(getattr(sj.instances, f))
        assert a.tobytes() == getattr(sp.instances, f).numpy().tobytes(), f
    assert sp.tlas is None and sj.tlas is None


def test_bvh_tables_byte_equal(pair):
    name, sj, sp = pair
    _assert_bvh_equal(sj, sp)
    assert sp.single_level == sj.single_level
    if name == 'mb_proto':
        # a motion-blurred prototype: the BVH tracer's alone
        assert sp.iclusters is None and sj.iclusters is None
        assert sp.mb_clusters is None and sj.mb_clusters is None
    # the scene carried across from the JAX build keeps its BVH
    _assert_bvh_equal(sj, to_port(sj))


def test_tlas_of_many_instances_byte_equal():
    """The Python TLAS build over 3,000 instances (the grid's 100,000 at a
    small count) and the shared BLAS."""
    kw = dict(width=8, height=8, n=3000, bvh=True)
    sj = cpu(registry.instanced_grid_standin, builder=rj.SceneBuilder(),
             **kw)[0]
    sp = cpu(registry.instanced_grid_standin, **kw)[0]
    assert sp.instances.root.shape[0] == 3000
    _assert_bvh_equal(sj, sp)


@pytest.mark.parametrize('leaf_size', [2, 8])
def test_build_refuses_other_leaf_sizes(leaf_size):
    """Both tracers test 4 lanes a leaf: a build with other leaves
    raises instead of leaving triangles that no walk tests."""
    b = rt.SceneBuilder()
    tie_scene(b)
    with pytest.raises(ValueError, match='leaf_size'):
        b.build(bvh=True, leaf_size=leaf_size, device='cpu')
    assert b.build(bvh=True, leaf_size=ttr.MAX_LEAF,
                   device='cpu').blas is not None


@pytest.fixture(scope='module')
def traces(pair):
    """(name, port scene, port results, JAX results) for nearest and
    any-hit rays with the test counters; every 16th ray is dead (tmax -1)
    and every 4th starts past the scene's middle."""
    name, sj, sp = pair
    o, d, tm, dist = scene_rays(sp, R, sorted(SCENES).index(name))
    out = {}
    for any_hit in (False, True):
        tmin, tmax = ray_bounds(dist, any_hit)
        hj, sj_st = jtr.bvh_trace(sj, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tm), jnp.asarray(tmin),
                                  jnp.asarray(tmax), any_hit=any_hit,
                                  collect_stats=True)
        t = torch.from_numpy
        hp, sp_st = ttr.bvh_trace(sp, t(o), t(d), t(tm), t(tmin), t(tmax),
                                  any_hit=any_hit, collect_stats=True)
        out[any_hit] = (hp, sp_st, jax.tree.map(np.asarray, (hj, sj_st)))
    return name, sp, out


def test_bvh_trace_nearest(traces):
    name, sp, out = traces
    hp, _, (hj, _) = out[False]
    tri = hp.tri.numpy()
    assert (tri >= 0).sum() > R // 8, 'too few hits to compare'
    np.testing.assert_array_equal(tri, hj.tri)
    np.testing.assert_array_equal(hp.inst.numpy(), hj.inst)
    np.testing.assert_allclose(hp.t.numpy(), hj.t, rtol=1e-5)
    # barycentrics within 1e-4: XLA may fuse multiply-adds on the CPU,
    # which moved one by 3.3e-5 on the atrium's 20-unit floor quads
    hit = tri >= 0
    np.testing.assert_allclose(hp.a.numpy()[hit], hj.a[hit], atol=1e-4)
    np.testing.assert_allclose(hp.b.numpy()[hit], hj.b[hit], atol=1e-4)
    if name == 'ties':
        # rays that hit a duplicated triangle: the rule kept one copy
        assert np.isin(tri, [0, 1, 2, 3, 4, 5]).sum() > 10


def test_bvh_trace_any_hit(traces):
    _, _, out = traces
    hp, _, (hj, _) = out[True]
    np.testing.assert_array_equal(hp.tri.numpy() >= 0, hj.tri >= 0)
    assert (hj.tri >= 0).any() and (hj.tri < 0).any()


@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_trace_counters(traces, any_hit):
    _, _, out = traces
    _, st, (_, stj) = out[any_hit]
    for k in ('ray_aabb', 'ray_tri'):
        np.testing.assert_array_equal(st[k].numpy(), stj[k], err_msg=k)
    assert int(st['ray_tri'].sum()) > 0


def test_push_order_is_a_stable_descending_sort():
    """The internal children's push order: torch's stable argsort of -key
    (with -inf for the other slots), ties to the lower slot."""
    rs = np.random.default_rng(3)
    near = torch.from_numpy(rs.integers(-2, 3, (200, 4)).astype(np.float32))
    near[::7, 1] = -0.0
    near[::7, 2] = 0.0
    internal = torch.from_numpy(rs.uniform(size=(200, 4)) < 0.7)
    rank = ttr._push_order(near, internal)
    key = torch.where(internal, near, -torch.inf)
    order = torch.argsort(-key, dim=1, stable=True)
    want = torch.empty_like(order).scatter_(1, order,
                                            torch.arange(4).expand(200, 4))
    assert torch.equal(rank, want)


def test_trace_fn_routes_to_bvh():
    """'bvh' traces any scene with a BVH; 'auto' takes it for a two-level
    scene without cluster tables; a scene without a BVH raises, and so
    does 'ring' without a process group."""
    _, sp = _pair('mb_proto')
    o, d, tm, _ = scene_rays(sp, R, 0)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
            1e-3, 1e12, False)
    for mode in ('auto', 'bvh'):
        calls = ttr.CALLS
        h = tint.trace_fn(sp, RenderSettings(intersector=mode))(*args)
        assert ttr.CALLS == calls + 1 and bool((h.tri >= 0).any())
    flat, _, _ = cpu(registry.triangle_sphere, size=8)
    with pytest.raises(ValueError, match='bvh=True'):
        tint.trace_fn(flat, RenderSettings(intersector='bvh'))
    # 'ring' needs the ranks of a process group
    with pytest.raises(RuntimeError, match='init_from_env'):
        tint.trace_fn(flat, RenderSettings(intersector='ring'))


def test_render_bvh_matches_jax():
    """sponza_standin cut to 12 spheres, 32 x 24, 3 bounces, traced
    through the BVH by both packages."""
    sj, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                      n_spheres=12, builder=rj.SceneBuilder(), bvh=True)
    want = jr.render(sj, jax_camera(cam), jax_settings(st, intersector='bvh'),
                     jax.random.PRNGKey(7))
    sp = to_port(sj)
    calls = ttr.CALLS
    got = rt.render(sp, cam, dataclasses.replace(st, intersector='bvh'),
                    rng.PRNGKey(7))
    assert ttr.CALLS > calls
    _assert_images_close(got.numpy(), np.asarray(want))
