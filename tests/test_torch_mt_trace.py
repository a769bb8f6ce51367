"""The brute-force Moller-Trumbore sweep (intersector 'pallas') in the port
against the JAX package's, on the CPU.

* ops/mt_trace.py against `mt_trace_pallas` in interpret mode on a random
  soup of 1,000 triangles with forced ties (duplicate triangles at other
  ids), padding lanes, per-ray tmin and tmax and dead rays: hit or miss
  and tri equal; t within rtol 1e-5, and a and b, which lie in [0, 1],
  within 1e-5 of that range, or 1e-4 where the ray grazes its triangle
  (|cos| < 0.1). XLA may fuse multiply-adds on the CPU; the port rounds
  each step, as the CUDA kernel built with -fmad=false does, and at
  grazing incidence the barycentrics' dot products cancel, which amplifies
  the difference.
* `mt_kernel.brute_trace` against `pallas_brute_trace` on
  `triangle_sphere`: the same tolerance.
* A render with intersector 'pallas' against the JAX package's, with the
  tolerance of tests/test_torch_render.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import pallas as jplk
from raytracer_tpu.ops.pallas import mt_kernel as jmt
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core.vecmath import MIRO_TMAX
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.ops import mt_trace as tmt
from raytracer_tpu_torch.ops.cuda import mt_kernel as mtk
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.render import integrator as tint
from raytracer_tpu_torch.scenes import registry

from .test_torch_render import _assert_images_close
from .torch_port_util import (cpu, jax_camera, jax_settings, to_port,
                              triangle_soup)


def _grazing(d, p0, p1, p2, tri):
    """Rays that meet their hit triangle at |cos| < 0.1."""
    k = np.maximum(np.asarray(tri), 0)
    n = np.cross(p1[k] - p0[k], p2[k] - p0[k])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.abs((n * d).sum(-1)) < 0.1


def _assert_hits_match(got, want, grazing, tol=1e-5):
    t, tri, a, b = (np.asarray(x) for x in got)
    tj, trij, aj, bj = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(tri, trij)
    hit = trij >= 0
    np.testing.assert_allclose(t, tj, rtol=tol)
    for x, y in ((a, aj), (b, bj)):
        for sel, atol in ((hit & ~grazing, tol), (hit & grazing, 10 * tol)):
            np.testing.assert_allclose(x[sel], y[sel], rtol=0, atol=atol)
    assert (t[~hit] == MIRO_TMAX).all() and (a[~hit] == 0).all()


@pytest.mark.parametrize('T', [1000, 1537])
def test_mt_trace_matches_pallas(T):
    """Tile-ragged triangle counts (1,537 is 3 tiles and 1 lane)."""
    args = triangle_soup(T, 512, seed=T)
    dup = args[-1]
    want = jmt.mt_trace_pallas(*map(jnp.asarray, args[:-1]), interpret=True)
    calls = tmt.CALLS
    got = tmt.mt_trace(*map(torch.from_numpy, args[:-1]))
    assert tmt.CALLS == calls + 1
    o, d, p0, p1, p2 = args[:5]
    _assert_hits_match(got, want, _grazing(d, p0, p1, p2, got[1]))
    tri = got[1].numpy()
    assert (tri >= 0).sum() > 200
    # a duplicated pair ties exactly and the lower id wins: no ray ends on
    # a copy, and many end on an original
    assert (tri < T - 64).all() and ((tri >= 0) & (tri < 64) & dup).sum() > 20
    lane = np.arange(512)
    assert (tri[lane % 16 == 3] == -1).all()              # dead rays


def test_mt_trace_tmin_tmax_and_padding():
    """Two stacked triangles (tests/test_pallas.py's case): tmin past the
    first gives the second, tmax before both misses; a padding lane is
    never hit."""
    p0 = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, -1.0, -3.0]])
    p1 = torch.tensor([[1.0, -1.0, -1.0], [1.0, -1.0, -3.0]])
    p2 = torch.tensor([[0.0, 1.0, -1.0], [0.0, 1.0, -3.0]])
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]])
    ones = torch.ones(2, dtype=torch.int32)
    t, tri, _, _ = tmt.mt_trace(o, d, p0, p1, p2, ones, 2.0, 1e12)
    assert int(tri[0]) == 1 and abs(float(t[0]) - 3.0) < 1e-5
    t, tri, _, _ = tmt.mt_trace(o, d, p0, p1, p2, ones, 1e-3, 0.5)
    assert int(tri[0]) == -1 and float(t[0]) == np.float32(MIRO_TMAX)
    t, tri, _, _ = tmt.mt_trace(o, d, p0, p1, p2,
                                torch.tensor([0, 1], dtype=torch.int32),
                                1e-3, 1e12)
    assert int(tri[0]) == 1


@pytest.fixture(scope='module')
def triangle_sphere():
    sj, cam, st = cpu(registry.triangle_sphere, size=24,
                      builder=rj.SceneBuilder())
    return sj, to_port(sj), cam, st


@pytest.mark.parametrize('any_hit', [False, True])
def test_brute_trace_matches_pallas_brute_trace(triangle_sphere, any_hit):
    sj, sp, cam, _ = triangle_sphere
    o, d, time = tcam.center_rays(cam, 24, 24)
    tmax = torch.full((o.shape[0],), 1e12)
    tmax[::7] = -1.0
    if any_hit:
        tmax[1::7] = 2.0
    want = jplk.pallas_brute_trace(sj, jnp.asarray(o.numpy()),
                                   jnp.asarray(d.numpy()), 0.0, 1e-3,
                                   jnp.asarray(tmax.numpy()), any_hit)
    calls = tmt.CALLS
    got = mtk.brute_trace(sp, o, d, time, 1e-3, tmax, any_hit)
    assert tmt.CALLS == calls + 1
    p = sp.geom.vertices[sp.geom.face_v.long()].numpy()
    _assert_hits_match((got.t, got.tri, got.a, got.b),
                       (want.t, want.tri, want.a, want.b),
                       _grazing(d.numpy(), p[:, 0], p[:, 1], p[:, 2],
                                got.tri))
    assert (got.inst == 0).all() and int((got.tri >= 0).sum()) > 100


def test_brute_trace_routes_mb_and_alpha_to_brute_force():
    """Motion-blurred and alpha scenes go to intersect.brute_force_trace,
    as the JAX package routes them; the sweep is not called."""
    for make in (registry.mb_bullet_standin, registry.alpha_leaf_standin):
        sp, cam, _ = cpu(make, 8)
        o, d, _ = tcam.center_rays(cam, 8, 8)
        calls = tmt.CALLS
        got = tint.trace_fn(sp, rt.RenderSettings(intersector='pallas'))(
            o, d, 0.5, 1e-3, 1e12, False)
        want = tisect.brute_force_trace(sp, o, d, 0.5, 1e-3, 1e12, False)
        assert tmt.CALLS == calls
        for f in ('t', 'tri', 'a', 'b'):
            assert torch.equal(getattr(got, f), getattr(want, f))


def test_mt_kernel_wrapper_devices():
    """CPU tensors take the plain version; another device raises."""
    args = [torch.from_numpy(x) for x in triangle_soup(64, 16, seed=1)[:-1]]
    launches, calls = mtk.LAUNCHES, tmt.CALLS
    got = mtk.mt_trace(*args)
    assert tmt.CALLS == calls + 1 and mtk.LAUNCHES == launches
    want = tmt.mt_trace(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='device'):
        mtk.mt_trace(*[x.to('meta') for x in args])


def test_render_pallas_matches_jax(triangle_sphere):
    sj, sp, cam, st = triangle_sphere
    st = dataclasses.replace(st, intersector='pallas')
    want = jr.render(sj, jax_camera(cam), jax_settings(st),
                     jax.random.PRNGKey(5))
    calls = tmt.CALLS
    got = rt.render(sp, cam, st, rng.PRNGKey(5))
    assert tmt.CALLS > calls
    _assert_images_close(got.numpy(), np.asarray(want))
