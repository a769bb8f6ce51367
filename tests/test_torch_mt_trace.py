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
from .torch_port_util import (cpu, jax_camera, jax_settings, mt_hit_key,
                              mt_split_trace, to_port, triangle_soup)


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


@pytest.mark.parametrize('sms', [1, 132])
def test_mt_split_decision(sms):
    """The MT kernel's grid (mt_kernel.split), against a direct count over
    ray and triangle counts from 1 to 2**21 rays and 1 to 9,000
    triangles: whole tiles a range; one range when the ray blocks alone
    fill FILL blocks an SM; else at least as many ranges as the fill needs,
    or one a tile."""
    fill = mtk.FILL * sms
    for R in (1, 511, 512, 4133, 32768, 270336, 2 ** 21):
        for T in (1, 255, 256, 257, 4133, 8836, 9000):
            per = mtk.split(R, T, sms)
            blocks = -(-R // mtk.BLOCK_RAYS)
            tiles = -(-T // mtk.TILE)
            ranges = -(-T // per)
            assert per % mtk.TILE == 0 and per > 0
            if blocks >= fill:
                assert ranges == 1, (R, T)
            else:
                assert ranges >= min(tiles, -(-fill // blocks)), (R, T)


def test_mt_hit_key_orders_hits():
    """The split grid's merge key (torch_port_util.mt_hit_key, the model
    of csrc/mt_trace.cu hit_key) orders hits as the sequential sweep does,
    against a direct sort: by t, -0 equal to +0, negative t below
    positive, then by triangle id; equal keys only for equal (t, id)."""
    rs = np.random.default_rng(3)
    scale = 10.0 ** rs.integers(-30, 30, 200)
    t = np.concatenate([rs.normal(size=200) * scale,
                        [0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38, 1.0, 1.0],
                        rs.choice([-2.0, 0.5, 7.0], 40)]).astype(np.float32)
    tri = rs.integers(0, 2 ** 31 - 1, t.shape[0]).astype(np.int32)
    tri[-40:] = rs.integers(0, 4, 40)              # ties in t and in id
    key = mt_hit_key(torch.from_numpy(t), torch.from_numpy(tri)).numpy()
    tz = np.where(t == 0, np.float32(0), t)
    order = np.lexsort((tri, tz))
    assert (np.diff(key[order]) >= 0).all()
    same = (tz[:, None] == tz[None]) & (tri[:, None] == tri[None])
    np.testing.assert_array_equal(key[:, None] == key[None], same)


@pytest.mark.parametrize('per_split', [256, 768])
def test_mt_split_trace_matches_sweep(per_split):
    """The sweep as the kernel's split grid merges it (modelled by
    torch_port_util.mt_split_trace) against the plain sweep, bit for bit
    (t, tri, a, b): a soup of 4,133 triangles whose last 64 repeat its
    first 64 (exact ties in different ranges: the lower id wins), negative
    t allowed on every 5th ray, dead rays."""
    args = list(triangle_soup(4133, 512, seed=8)[:-1])
    args[6] = np.where(np.arange(512) % 5 == 0, -np.inf,
                       args[6]).astype(np.float32)
    args = [torch.from_numpy(x) for x in args]
    want = tmt.mt_trace(*args)
    got = mt_split_trace(*args, per_split)
    for g, w, f in zip(got, want, ('t', 'tri', 'a', 'b')):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f)
    tri, t = want[1].numpy(), want[0].numpy()
    assert (tri < 4133 - 64).all() and ((tri >= 0) & (tri < 64)).sum() > 20
    assert ((tri >= 0) & (t < 0)).any()
