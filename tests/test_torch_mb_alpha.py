"""Motion blur and alpha cutouts in the port against the JAX package, on
the CPU.

* The cluster tracer's `mb` mode (the basis lerped per component as
  p + time (q - p)) and its `need_ab` mode (the winning lane's own a, b),
  plain PyTorch, against `pallas_cluster_trace` in interpret mode: hit or
  miss and tri equal, t within rtol 1e-5 (XLA may fuse the lerp's
  multiply-add, the port rounds each step; -fmad=false keeps the CUDA
  kernel on the port's side), a and b within 1e-4 (the same, through the
  Moller-Trumbore ratios).
* The instanced tracers' `need_ab` mode against `pallas_iseg_trace` and
  `pallas_icluster_trace`, held as tests/test_torch_instanced.py holds
  their nearest mode (t with atol 1e-5 for instance hits).
* Exact any-hit in alpha scenes: the port returns the nearest hit. The
  Pallas kernel stops a ray's block after the first 16-cluster batch that
  holds a hit for the ray and returns that batch's minimum, which depends
  on the block. They must agree on hit or miss; where they return the same
  triangle, t agrees; the count of rays where the triangle differs is
  printed and bounded.
* `alpha_aware_trace` against the JAX march around the same tracer (the
  brute-force tracer with the alpha test left out), at a ray count that
  exercises the shrinking pass budget, and with the pass budget exhausted.
* Renders of `mb_bullet_standin` and `alpha_leaf_standin` against
  `raytracer_tpu.render` (tolerance as tests/test_torch_render.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu.ops import intersect as jisect
from raytracer_tpu.ops.pallas import cluster_kernel as jck
from raytracer_tpu.ops.pallas import icluster_kernel as jick
from raytracer_tpu.ops.pallas import iseg_kernel as jisk
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.scenes import registry

from .test_torch_render import _assert_images_close
from .torch_port_util import (cpu, jax_camera, jax_settings, random_rays,
                              to_port)

R = 512


def _pair(make, **kw):
    sj, cam, st = cpu(make, builder=rj.SceneBuilder(), **kw)
    return sj, to_port(sj), cam, st


@pytest.fixture(scope='module')
def mb_bullet():
    return _pair(registry.mb_bullet_standin, size=16)


@pytest.fixture(scope='module')
def alpha_leaf():
    return _pair(registry.alpha_leaf_standin, size=16, max_bounces=2)


@pytest.fixture(scope='module')
def forests():
    """final_forest_standin with two trees (hierarchical tracer) and with
    none (segment tracer), small counts."""
    return {n: _pair(registry.final_forest_standin, width=16, height=16,
                     n_trees=n, n_flowers=6, grass_grid=4, bvh=True)
            for n in (2, 0)}


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_close(ht, hj, any_hit, ab=True, atol_t=0.0):
    tri_t, tri_j = ht.tri.numpy(), np.asarray(hj.tri)
    np.testing.assert_array_equal(tri_t >= 0, tri_j >= 0)       # hit or miss
    assert (tri_j >= 0).sum() > len(tri_j) // 20, 'too few hits'
    same = tri_t == tri_j
    if any_hit:
        # the nearest hit against the block's first batch with a hit
        assert same.mean() > 0.8
    else:
        assert same.all()
    np.testing.assert_allclose(ht.t.numpy()[same], np.asarray(hj.t)[same],
                               rtol=1e-5, atol=atol_t)
    if ab:
        for f in ('a', 'b'):
            np.testing.assert_allclose(getattr(ht, f).numpy()[same],
                                       np.asarray(getattr(hj, f))[same],
                                       atol=1e-4)
    return int((~same).sum())


@pytest.mark.parametrize('any_hit', [False, True])
def test_mb_plain_matches_pallas(mb_bullet, any_hit):
    """`mb` mode on a motion-blurred single-level scene without alpha
    maps: nearest (a, b recomputed from the lerped vertices) and
    `cheap_any`."""
    sj, sp, _, _ = mb_bullet
    # rays around the moving shards (both poses), not the large floor
    g = sp.geom
    v = torch.cat([g.vertices, g.vertices_t1])[
        torch.cat([g.face_v[g.face_mb]] * 2).reshape(-1).long()]
    o, d, time, dist = random_rays(v.amin(0)[None], v.amax(0)[None],
                                   np.zeros((1, 1)), R, 3)
    tmax = (dist * 1.2 if any_hit else np.full(R, 1e12)).astype(np.float32)
    tmax[::7] = -1.0
    hj = jck.pallas_cluster_trace(sj, _j(o), _j(d), _j(time), 1e-3, _j(tmax),
                                  any_hit)
    ht = ct.cluster_trace(sp, _t(o), _t(d), _t(time), 1e-3, _t(tmax),
                          any_hit)
    _assert_close(ht, hj, False, ab=not any_hit)
    assert (ht.tri.numpy()[::7] == -1).all()
    if not any_hit:   # the time matters: a static trace misses or moves
        hs = ct.cluster_trace(sp, _t(o), _t(d), 0.0, 1e-3, _t(tmax), False)
        assert (hs.tri != ht.tri).sum() > R // 20


@pytest.mark.parametrize('any_hit', [False, True])
def test_mb_need_ab_plain_matches_pallas(forests, any_hit):
    """`mb` + `need_ab` on the forest's motion-blurred partition, nearest
    and exact any-hit, random shutter times."""
    sj, sp, _, _ = forests[2]
    cl = sp.mb_clusters
    o, d, time, _ = random_rays(cl.bb_min, cl.bb_max, cl.tri, R, 4)
    tmax = np.full(R, 1e12, np.float32)
    tmax[::7] = -1.0
    hj = jck.pallas_cluster_trace(sj, _j(o), _j(d), _j(time), 1e-3, _j(tmax),
                                  any_hit, table=sj.mb_clusters, mb=True)
    ht = ct.cluster_trace(sp, _t(o), _t(d), _t(time), 1e-3, _t(tmax),
                          any_hit, table=cl, mb=True)
    n = _assert_close(ht, hj, any_hit)
    print(f'mb partition, any_hit={any_hit}: {n} of {R} rays on another '
          f'triangle')


@pytest.mark.parametrize('any_hit', [False, True])
def test_need_ab_plain_matches_pallas(alpha_leaf, any_hit):
    """Static `need_ab` on alpha_leaf_standin's camera rays."""
    sj, sp, cam, _ = alpha_leaf
    o, d, _ = tcam.center_rays(cam, 32, R // 32)
    tmax = np.full(R, 1e12, np.float32)
    tmax[::7] = -1.0
    hj = jck.pallas_cluster_trace(sj, _j(o), _j(d), 0.0, 1e-3, _j(tmax),
                                  any_hit)
    ht = ct.cluster_trace(sp, o, d, 0.0, 1e-3, _t(tmax), any_hit)
    n = _assert_close(ht, hj, any_hit)
    print(f'alpha leaf, any_hit={any_hit}: {n} of {R} rays on another '
          f'triangle')


def _forest_rays(sp, cam, seed):
    """Half camera rays, half rays from near the camera in random
    directions -> numpy (o, d)."""
    o, d, _ = tcam.center_rays(cam, 16, R // 32)
    rs = np.random.default_rng(seed)
    o2 = cam.eye.numpy() + rs.uniform(-1, 1, (R // 2, 3)) * [3, 0.1, 3]
    o2[:, 1] = np.abs(o2[:, 1]) + 0.05
    d2 = rs.normal(size=(R // 2, 3)) + [0, 0.3, 0]
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    f = lambda x: np.asarray(x, np.float32)
    return f(np.concatenate([o.numpy(), o2])), f(np.concatenate([d.numpy(),
                                                                d2]))


@pytest.mark.parametrize('n_trees', [2, 0])
@pytest.mark.parametrize('any_hit', [False, True])
def test_instanced_need_ab_plain_matches_pallas(forests, n_trees, any_hit):
    """`need_ab`, nearest and exact any-hit, of the hierarchical (two
    trees) and segment (no trees) tracers on the forest."""
    sj, sp, cam, _ = forests[n_trees]
    jtrace, plain = ((jick.pallas_icluster_trace, ict.icluster_trace)
                     if n_trees else (jisk.pallas_iseg_trace, ist.iseg_trace))
    assert (sp.iclusters.max_proto_clusters > 16) == bool(n_trees)
    o, d = _forest_rays(sp, cam, 5)
    tmax = np.full(R, 1e12, np.float32)
    tmax[::7] = -1.0
    hj = jtrace(sj, _j(o), _j(d), 0.0, 1e-3, _j(tmax), any_hit, rb=32)
    ht = plain(sp, _t(o), _t(d), 0.0, 1e-3, _t(tmax), any_hit)
    same = (ht.tri.numpy() == np.asarray(hj.tri)) \
        & (ht.inst.numpy() == np.asarray(hj.inst))
    n = _assert_close(ht, hj, any_hit, atol_t=1e-5)
    if not any_hit:
        assert same.all()
    print(f'{plain.__name__}, any_hit={any_hit}: {n} of {R} rays on another '
          f'triangle')


def _march_tracers(sj, sp):
    """The brute-force tracer of both packages with the alpha test left
    out (the scene's flag off), so the march sees every cutout hit."""
    sj0 = sj.replace(has_alpha_maps=False)
    sp0 = dataclasses.replace(sp, has_alpha_maps=False)

    def jtrace(o, d, time, tmin, tmax, any_hit):
        return jisect.brute_force_trace(sj0, o, d, time, tmin, tmax, False)

    def ttrace(o, d, time, tmin, tmax, any_hit):
        return tisect.brute_force_trace(sp0, o, d, time, tmin, tmax, False)
    return jtrace, ttrace


@pytest.mark.parametrize('max_passes', [12, 2])
def test_alpha_aware_trace_matches_jax(alpha_leaf, max_passes):
    """16,384 rays through the two leaf cards: pass p of the march traces
    max(4096, R >> (p + 1)) rows of the live-first partition; with 2
    passes, rays still live keep their last cutout hit."""
    sj, sp, cam, _ = alpha_leaf
    n = 16384
    rs = np.random.default_rng(10)
    tgt = np.stack([rs.uniform(-3.2, 0.2, n), rs.uniform(-1.2, 1.7, n),
                    np.zeros(n)], -1)
    o = np.asarray([-1.5, 0.25, 4.0]) + rs.normal(size=(n, 3)) * 0.2
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = _t(o.astype(np.float32)), _t(d.astype(np.float32))
    tmax = np.full(n, 1e12, np.float32)
    tmax[::11] = -1.0
    jtrace, ttrace = _march_tracers(sj, sp)
    hj = jax.jit(lambda o, d, tmax: jct.alpha_aware_trace(
        sj, jtrace, o, d, 0.0, 1e-3, tmax, False, max_passes))(
            _j(o), _j(d), _j(tmax))
    p0 = ct.MARCH_PASSES
    ht = ct.alpha_aware_trace(sp, ttrace, o, d, 0.0, 1e-3, _t(tmax), False,
                              max_passes)
    passes = ct.MARCH_PASSES - p0
    assert 2 <= passes <= max_passes
    for f in ('tri', 'inst'):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)))
    for f in ('t', 'a', 'b'):
        np.testing.assert_allclose(getattr(ht, f).numpy(),
                                   np.asarray(getattr(hj, f)), rtol=1e-5,
                                   atol=1e-6)
    hits = ht.tri.numpy() >= 0
    assert 0.1 < hits.mean() < 0.9
    # a cutout hit stood in for every ray the two passes left live
    alpha = tisect.alpha_of(sp, ht.tri.clamp(min=0), ht.a, ht.b).numpy()
    assert (hits & (alpha < 0.5)).any() == (max_passes == 2)


def test_alpha_march_any_hit_rule(forests):
    """Shadow rays of the forest through the whole march: the port's exact
    any-hit (the nearest hit) against the Pallas kernel's block-dependent
    one. Shadowed or not must agree on all but a few rays; the count is
    printed."""
    from raytracer_tpu.render import integrator as jint
    from raytracer_tpu_torch.core.types import RenderSettings
    from raytracer_tpu_torch.render import integrator as tint
    sj, sp, cam, st = forests[2]
    o, d = _forest_rays(sp, cam, 9)
    tmax = np.full(R, 30.0, np.float32)
    jtrace = jint.trace_fn(sj, jax_settings(st, intersector='cluster2'))
    ttrace = tint.trace_fn(sp, RenderSettings())
    hj = jax.jit(lambda o, d, tmax: jtrace(o, d, 0.95, 1e-3, tmax, True))(
        _j(o), _j(d), _j(tmax))
    ht = ttrace(_t(o), _t(d), 0.95, 1e-3, _t(tmax), True)
    shadow_j, shadow_t = np.asarray(hj.tri) >= 0, ht.tri.numpy() >= 0
    assert shadow_j.sum() > R // 10
    differ = int((shadow_j != shadow_t).sum())
    other = int(((np.asarray(hj.tri) != ht.tri.numpy()) & shadow_j).sum())
    print(f'forest shadow rays: {differ} of {R} differ in shadowed or not; '
          f'{other} hit another triangle')
    assert differ <= R // 50


def test_render_mb_bullet_matches_jax(mb_bullet):
    """A 1.0 shutter: every ray draws its own time."""
    sj, sp, cam, st = mb_bullet
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster_pallas'),
                     jax.random.PRNGKey(7))
    got = rt.render(sp, cam, st, rng.PRNGKey(7))
    _assert_images_close(got.numpy(), np.asarray(want))


def test_render_alpha_leaf_matches_jax(alpha_leaf):
    """Path traced, alpha march on every trace, translucency, env map."""
    sj, sp, cam, st = alpha_leaf
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster_pallas'),
                     jax.random.PRNGKey(5))
    passes = ct.MARCH_PASSES
    got = rt.render(sp, cam, st, rng.PRNGKey(5))
    assert ct.MARCH_PASSES > passes
    _assert_images_close(got.numpy(), np.asarray(want))
