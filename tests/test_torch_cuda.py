"""The CUDA trace kernels (cluster, segment and hierarchical instance trace,
the brute-force Moller-Trumbore sweep and the wide-BVH walk) and the
threefry random-number kernel against their plain PyTorch versions, the
take-scatter kernel (the backward of core/vecmath.take) against
index_add_, and the trainer's loss and gradients, the edge-sampled boundary
terms, adaptive renders and the baked stone texture against the CPU's, on
the card. Every test here needs an
NVIDIA GPU and nvcc, and skips elsewhere.

This file imports torch and the port only, so it runs on a machine without
jax; tests/conftest.py imports jax, so run it there with
    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Both sides run the same unfused float32 arithmetic (the kernel is built
with -fmad=false) and the same visiting rule, so `t` and `tri` must agree
exactly, and `inst` too for the instanced kernels. Renders compare to the CPU render of the same key with the
tolerance of tests/test_torch_render.py (elementwise transcendental
functions differ between the CPU and CUDA libraries by an ulp or two).
"""
import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.ops import bundle
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.ops import mt_trace as tmt
from raytracer_tpu_torch.ops import traverse as ttr
from raytracer_tpu_torch.ops.cuda import bvh_kernel as bvk
from raytracer_tpu_torch.ops.cuda import cluster_kernel as ck
from raytracer_tpu_torch.ops.cuda import icluster_kernel as ick
from raytracer_tpu_torch.ops.cuda import iseg_kernel as isk
from raytracer_tpu_torch.ops.cuda import mt_kernel as mtk
from raytracer_tpu_torch.ops.cuda import rng_kernel as rk
from raytracer_tpu_torch.ops.cuda import take_kernel as tk
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.utils import counters

from .torch_port_util import (box_rays, cluster_table, cpu,
                              edge_sample_parity, filled_scene, grazing_rays,
                              instanced_table, ray_bounds, scene_rays,
                              segment_table, table_rays, tie_scene,
                              triangle_soup)

pytestmark = pytest.mark.cuda
R = 4096


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (run on the card)')
    return torch.device('cuda', 0)


@pytest.fixture(scope='module', params=['triangle_sphere', 'sponza_12',
                                        'sponza_full'])
def scene(request, dev):
    if request.param == 'triangle_sphere':
        s, cam, st = cpu(registry.triangle_sphere, size=16)
    else:
        n = 12 if request.param == 'sponza_12' else 300
        s, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                                             n_spheres=n)
    return s, s.to(dev), cam


def _rays(scene, cam, kind, seed=1):
    """Incoherent rays around the scene's box or coherent camera rays, with
    a per-ray any-hit distance -> CPU tensors (o, d, dist)."""
    rs = np.random.default_rng(seed)
    if kind == 'camera':
        o, d, _ = cam_mod.center_rays(cam, 64, R // 64)
        dist = rs.uniform(0.5, 10.0, R)
    else:
        real = scene.clusters.tri[:, 0] >= 0
        lo = scene.clusters.bb_min[real].amin(0).numpy()
        hi = scene.clusters.bb_max[real].amax(0).numpy()
        o = lo + rs.uniform(size=(R, 3)) * (hi - lo)
        d = rs.normal(size=(R, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dist = rs.uniform(0.1, 1.0, R) * np.linalg.norm(hi - lo)
        o, d = torch.tensor(o, dtype=torch.float32), \
            torch.tensor(d, dtype=torch.float32)
    return o, d, torch.tensor(dist, dtype=torch.float32)


@pytest.mark.parametrize('kind', ['random', 'camera'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_matches_plain(scene, dev, kind, any_hit):
    host, card, cam = scene
    o, d, dist = _rays(host, cam, kind)
    tmax = dist if any_hit else torch.full((R,), 1e12)
    tmax[::5] = -1.0                               # dead lanes
    hp = ct.cluster_trace(host, o, d, 0.0, 1e-3, tmax, any_hit)
    n0 = ck.LAUNCHES
    hk = ck.cluster_trace(card, o.to(dev), d.to(dev), 0.0, 1e-3,
                          tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == n0 + 1
    assert int((hp.tri >= 0).sum()) > R // 20
    np.testing.assert_array_equal(hk.tri.cpu().numpy(), hp.tri.numpy())
    np.testing.assert_array_equal(hk.t.cpu().numpy(), hp.t.numpy())
    np.testing.assert_allclose(hk.a.cpu().numpy(), hp.a.numpy(), atol=1e-6)
    np.testing.assert_allclose(hk.b.cpu().numpy(), hp.b.numpy(), atol=1e-6)


def test_plain_on_card_matches_plain_on_cpu(scene, dev):
    host, card, cam = scene
    o, d, _ = _rays(host, cam, 'random', seed=2)
    hp = ct.cluster_trace(host, o, d, 0.0, 1e-3, 1e12, False)
    hg = ct.cluster_trace(card, o.to(dev), d.to(dev), 0.0, 1e-3, 1e12, False)
    np.testing.assert_array_equal(hg.tri.cpu().numpy(), hp.tri.numpy())
    np.testing.assert_array_equal(hg.t.cpu().numpy(), hp.t.numpy())


def test_kernel_rejects_bad_inputs(scene, dev):
    _, card, cam = scene
    o, d, _ = _rays(card, cam, 'camera')
    o, d = o.to(dev), d.to(dev)
    with pytest.raises(ValueError):
        ck.launch(card.clusters, o.double(), d, torch.zeros(R, device=dev),
                  torch.ones(R, device=dev), False)
    with pytest.raises(ValueError):
        ck.launch(card.clusters, o.t().contiguous().t(), d,
                  torch.zeros(R, device=dev), torch.ones(R, device=dev),
                  False)
    with pytest.raises(ValueError):
        ck.launch(card.clusters, o.cpu(), d, torch.zeros(R, device=dev),
                  torch.ones(R, device=dev), False)


def test_render_on_card_matches_cpu(dev):
    scene, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                                             n_spheres=12)
    key = rng.PRNGKey(11)
    want = rt.render(scene, cam, st, key).numpy()
    n0, c0 = ck.LAUNCHES, ct.CALLS
    got = rt.render(scene.to(dev), cam.to(dev), st, key)
    torch.cuda.synchronize()
    assert ck.LAUNCHES > n0 and ct.CALLS == c0
    got = got.cpu().numpy()
    d = np.abs(got - want)
    assert (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
    assert d.mean() < 1e-3 * np.abs(want).mean()


# instanced scenes: (builder, kwargs, kernel module, kernel name); the
# 17,000-instance grid has 34,000 segments, past the Pallas kernel's
# 32,767-entry slice limit
INSTANCED = {
    'teapots': (registry.instanced_teapots_standin, {}, isk, 'iseg_trace'),
    'grid_17k': (registry.instanced_grid_standin, dict(n=17_000), isk,
                 'iseg_trace'),
    'forest_24': (registry.forest_standin, dict(n_trees=24), ick,
                  'icluster_trace'),
    'forest_200': (registry.forest_standin, {}, ick, 'icluster_trace'),
}
PLAIN = {'iseg_trace': ist.iseg_trace, 'icluster_trace': ict.icluster_trace}


@pytest.fixture(scope='module', params=sorted(INSTANCED))
def instanced(request, dev):
    make, kw, mod, name = INSTANCED[request.param]
    s, cam, _ = cpu(make, 32, 24, **kw)
    return s, s.to(dev), cam, mod, name


def _instanced_rays(scene, cam, kind, seed=1):
    """Camera rays, or random rays from the lowest 2.5 m of the instances'
    box -> CPU tensors (o, d)."""
    if kind == 'camera':
        o, d, _ = cam_mod.center_rays(cam, 64, R // 64)
        return o, d
    rs = np.random.default_rng(seed)
    ibb = scene.iclusters.ibb
    real = ibb[0] < 1e37
    lo, hi = ibb[:3, real].amin(1).numpy(), ibb[3:, real].amax(1).numpy()
    hi[1] = min(hi[1], lo[1] + 2.5)
    o = lo + rs.uniform(size=(R, 3)) * (hi - lo)
    d = rs.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize('kind', ['random', 'camera'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_instanced_kernel_matches_plain(instanced, dev, kind, any_hit):
    host, card, cam, mod, name = instanced
    o, d = _instanced_rays(host, cam, kind)
    tmax = torch.full((R,), 1e12)
    if any_hit:
        near = PLAIN[name](host, o, d, 0.0, 1e-3, tmax, False).t
        u = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.5, R),
                         dtype=torch.float32)
        tmax = torch.clamp(near * u, max=1e12)
    tmax[::5] = -1.0                               # dead lanes
    hp = PLAIN[name](host, o, d, 0.0, 1e-3, tmax, any_hit)
    n0 = mod.LAUNCHES
    hk = getattr(mod, name)(card, o.to(dev), d.to(dev), 0.0, 1e-3,
                            tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == n0 + 1
    assert int((hp.tri >= 0).sum()) > R // 20
    assert (hp.tri[::5] == -1).all()
    for f in ('tri', 'inst', 't'):
        np.testing.assert_array_equal(getattr(hk, f).cpu().numpy(),
                                      getattr(hp, f).numpy())
    np.testing.assert_allclose(hk.a.cpu().numpy(), hp.a.numpy(), atol=1e-6)
    np.testing.assert_allclose(hk.b.cpu().numpy(), hp.b.numpy(), atol=1e-6)


def test_instanced_kernel_rejects_bad_inputs(instanced, dev):
    _, card, cam, mod, _ = instanced
    o, d = _instanced_rays(card, cam, 'camera')
    o, d = o.to(dev), d.to(dev)
    ones = torch.ones(R, device=dev)
    with pytest.raises(ValueError):
        mod.launch(card.iclusters, o.double(), d, 0 * ones, ones, False)
    with pytest.raises(ValueError):
        mod.launch(card.iclusters, o.cpu(), d, 0 * ones, ones, False)


def test_instanced_render_on_card_matches_cpu(dev):
    scene, cam, st = cpu(registry.instanced_teapots_standin, 32, 24)
    key = rng.PRNGKey(11)
    want = rt.render(scene, cam, st, key).numpy()
    n0, c0 = isk.LAUNCHES, ist.CALLS
    got = rt.render(scene.to(dev), cam.to(dev), st, key)
    torch.cuda.synchronize()
    assert isk.LAUNCHES > n0 and ist.CALLS == c0
    got = got.cpu().numpy()
    d = np.abs(got - want)
    assert (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
    assert d.mean() < 1e-3 * np.abs(want).mean()


# ------------------------------------------- motion blur and alpha modes
def _box_rays(bb_min, bb_max, tri, seed, n=R):
    """Rays from around a table's box aimed at random points inside it,
    with random shutter times -> CPU tensors (o, d, time)."""
    rs = np.random.default_rng(seed)
    real = tri[:, 0] >= 0
    lo = bb_min[real].amin(0).numpy()
    hi = bb_max[real].amax(0).numpy()
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = ctr + rs.normal(size=(n, 3)) * ext
    d = ctr + rs.uniform(-0.5, 0.5, (n, 3)) * ext - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)
    return f(o), f(d), f(rs.uniform(size=n))


@pytest.fixture(scope='module')
def forest_small(dev):
    """final_forest_standin with two trees (the hierarchical tracer) and
    with none (the segment tracer), on both devices."""
    out = {}
    for n_trees in (2, 0):
        s, cam, _ = cpu(registry.final_forest_standin,
            32, 24, n_trees=n_trees, n_flowers=6, grass_grid=4)
        out[n_trees] = (s, s.to(dev), cam)
    return out


def _assert_hits_equal(hk, hp, fields=('tri', 'inst', 't', 'a', 'b')):
    for f in fields:
        np.testing.assert_array_equal(getattr(hk, f).cpu().numpy(),
                                      getattr(hp, f).numpy(), err_msg=f)


@pytest.mark.parametrize('any_hit', [False, True])
def test_mb_kernel_matches_plain(dev, any_hit):
    """The cluster kernel in `mb` mode on mb_bullet_standin (no alpha maps:
    nearest and cheap any-hit), random shutter times and dead lanes."""
    host, cam, _ = cpu(registry.mb_bullet_standin, 16)
    card = host.to(dev)
    cl = host.clusters
    assert cl.p0_t1 is not cl.p0
    o, d, time = _box_rays(cl.bb_min, cl.bb_max, cl.tri, 4)
    tmax = torch.full((R,), 1e12)
    if any_hit:   # stop at 0.5-1.5 times the nearest hit
        near = ct.cluster_trace(host, o, d, time, 1e-3, tmax, False).t
        u = torch.tensor(np.random.default_rng(5).uniform(0.5, 1.5, R),
                         dtype=torch.float32)
        tmax = torch.clamp(near * u, max=1e12)
    tmax[::5] = -1.0
    hp = ct.cluster_trace(host, o, d, time, 1e-3, tmax, any_hit)
    n0 = ck.MODES['mb+' + ('cheap_any' if any_hit else 'nearest')]
    hk = ck.cluster_trace(card, o.to(dev), d.to(dev), time.to(dev), 1e-3,
                          tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    assert ck.MODES['mb+' + ('cheap_any' if any_hit else 'nearest')] == n0 + 1
    assert int((hp.tri >= 0).sum()) > R // 20
    _assert_hits_equal(hk, hp, ('tri', 't'))
    np.testing.assert_allclose(hk.a.cpu().numpy(), hp.a.numpy(), atol=1e-6)
    np.testing.assert_allclose(hk.b.cpu().numpy(), hp.b.numpy(), atol=1e-6)


@pytest.mark.parametrize('any_hit', [False, True])
def test_mb_need_ab_kernel_matches_plain(forest_small, dev, any_hit):
    """The cluster kernel in `mb` + `need_ab` mode on the forest's
    motion-blurred partition: nearest and exact any-hit give the same
    t, tri, a and b bit for bit."""
    host, card, _ = forest_small[2]
    cl = host.mb_clusters
    o, d, time = _box_rays(cl.bb_min, cl.bb_max, cl.tri, 6)
    tmax = torch.full((R,), 1e12)
    tmax[::5] = -1.0
    hp = ct.cluster_trace(host, o, d, time, 1e-3, tmax, any_hit,
                          table=cl, mb=True)
    hk = ck.cluster_trace(card, o.to(dev), d.to(dev), time.to(dev), 1e-3,
                          tmax.to(dev), any_hit, table=card.mb_clusters,
                          mb=True)
    torch.cuda.synchronize()
    assert int((hp.tri >= 0).sum()) > R // 20
    assert (hp.tri[::5] == -1).all()
    _assert_hits_equal(hk, hp)


@pytest.mark.parametrize('any_hit', [False, True])
def test_need_ab_kernel_matches_plain(dev, any_hit):
    """The static cluster kernel in `need_ab` mode on alpha_leaf_standin."""
    host, cam, _ = cpu(registry.alpha_leaf_standin, 16)
    card = host.to(dev)
    o, d, _ = cam_mod.center_rays(cam, 64, R // 64)
    tmax = torch.full((R,), 1e12)
    tmax[::5] = -1.0
    hp = ct.cluster_trace(host, o, d, 0.5, 1e-3, tmax, any_hit)
    hk = ck.cluster_trace(card, o.to(dev), d.to(dev), 0.5, 1e-3,
                          tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    assert int((hp.tri >= 0).sum()) > R // 20
    _assert_hits_equal(hk, hp, ('tri', 't', 'a', 'b'))


@pytest.mark.parametrize('n_trees', [2, 0])
@pytest.mark.parametrize('any_hit', [False, True])
def test_instanced_need_ab_kernel_matches_plain(forest_small, dev, n_trees,
                                                any_hit):
    """The hierarchical (two trees) and segment (no trees) kernels in
    `need_ab` mode, nearest and exact any-hit, on camera rays and random
    rays near the ground, with dead lanes."""
    host, card, cam = forest_small[n_trees]
    mod, name = (ick, 'icluster_trace') if n_trees else (isk, 'iseg_trace')
    assert (host.iclusters.max_proto_clusters > 16) == bool(n_trees)
    o, d = _instanced_rays(host, cam, 'camera')
    o2, d2 = _instanced_rays(host, cam, 'random', seed=7)
    o, d = torch.cat([o[:R // 2], o2[:R // 2]]), torch.cat([d[:R // 2],
                                                           d2[:R // 2]])
    tmax = torch.full((R,), 1e12)
    tmax[::5] = -1.0
    hp = PLAIN[name](host, o, d, 0.0, 1e-3, tmax, any_hit)
    key = ('exact_any' if any_hit else 'nearest') + '+need_ab'
    n0 = mod.MODES[key]
    hk = getattr(mod, name)(card, o.to(dev), d.to(dev), 0.0, 1e-3,
                            tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    assert mod.MODES[key] == n0 + 1
    assert int((hp.tri >= 0).sum()) > R // 20
    _assert_hits_equal(hk, hp)


def test_alpha_march_on_card_matches_cpu(forest_small, dev):
    """The whole forest tracer (alpha march, motion-blurred partition
    hoisted) on the card against the CPU, bit for bit."""
    from raytracer_tpu_torch.core.types import RenderSettings
    from raytracer_tpu_torch.render import integrator
    host, card, cam = forest_small[2]
    o, d = _instanced_rays(host, cam, 'camera')
    time = torch.tensor(np.random.default_rng(8).uniform(0.9, 1.0, R),
                        dtype=torch.float32)
    for any_hit in (False, True):
        hp = integrator.trace_fn(host, RenderSettings())(
            o, d, time, 1e-3, 1e12, any_hit)
        hk = integrator.trace_fn(card, RenderSettings())(
            o.to(dev), d.to(dev), time.to(dev), 1e-3, 1e12, any_hit)
        _assert_hits_equal(hk, hp)


def test_forest_render_on_card_matches_cpu(forest_small, dev):
    s, cam, st = cpu(registry.final_forest_standin,
        32, 24, n_trees=2, n_flowers=6, grass_grid=4, max_bounces=1,
        dome_samples=1)
    key = rng.PRNGKey(13)
    want = rt.render(s, cam, st, key).numpy()
    n0, c0 = ick.LAUNCHES + ck.LAUNCHES, ict.CALLS + ct.CALLS
    got = rt.render(s.to(dev), cam.to(dev), st, key)
    torch.cuda.synchronize()
    assert ick.LAUNCHES + ck.LAUNCHES > n0 and ict.CALLS + ct.CALLS == c0
    got = got.cpu().numpy()
    dd = np.abs(got - want)
    assert (dd <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
    assert dd.mean() < 1e-3 * np.abs(want).mean()


def test_asset_final_forest_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The registry's `final_forest` with three trees, built from the
    stand-in asset tree (scenes/assets.write_tree): the card's render (the
    hierarchical instance and cluster kernels) against the CPU's."""
    from raytracer_tpu_torch.scenes import assets
    assets.write_tree(str(tmp_path))
    monkeypatch.setenv('RT_ASSETS', str(tmp_path))
    s, cam, st = cpu(registry.final_forest, 32, 24, n_trees=3, n_flowers=6,
                     grass_grid=4, max_bounces=1, dome_samples=1)
    key = rng.PRNGKey(17)
    want = rt.render(s, cam, st, key).numpy()
    n0, c0 = ick.LAUNCHES + ck.LAUNCHES, ict.CALLS + ct.CALLS
    got = rt.render(s.to(dev), cam.to(dev), st, key)
    torch.cuda.synchronize()
    assert ick.LAUNCHES + ck.LAUNCHES > n0 and ict.CALLS + ct.CALLS == c0
    got = got.cpu().numpy()
    dd = np.abs(got - want)
    assert (dd <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
    assert dd.mean() < 1e-3 * np.abs(want).mean()


def _mt_launches(dev, n_rays, T):
    """The device kernels of one MT kernel call on this card."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return mtk.device_launches(n_rays, T, mtk.split(n_rays, T, sms))


@pytest.mark.parametrize('T', [1000, 4133])
def test_mt_kernel_matches_plain(dev, T):
    """The MT kernel bit for bit with its plain version on a soup with
    forced ties, padding lanes, per-ray bounds and dead rays; 4,133
    triangles is 8 tiles and 37 lanes."""
    args = triangle_soup(T, R, seed=T)[:-1]
    want = tmt.mt_trace(*map(torch.from_numpy, args))
    n0 = mtk.LAUNCHES
    got = mtk.mt_trace(*[torch.from_numpy(x).to(dev) for x in args])
    torch.cuda.synchronize()
    assert mtk.LAUNCHES == n0 + _mt_launches(dev, R, T)
    assert int((want[1] >= 0).sum()) > R // 4
    for g, w, f in zip(got, want, ('t', 'tri', 'a', 'b')):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=f)
    assert (got[1].cpu()[3::16] == -1).all()


@pytest.mark.parametrize('kind', ['random', 'camera'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_brute_trace_kernel_matches_plain(dev, kind, any_hit):
    """intersector 'pallas' on the 12-sphere sponza_standin: the kernel
    on the card against the plain version on the CPU."""
    host, cam, _ = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                       n_spheres=12)
    card = host.to(dev)
    o, d, dist = _rays(host, cam, kind)
    tmax = dist if any_hit else torch.full((R,), 1e12)
    tmax[::5] = -1.0
    hp = mtk.brute_trace(host, o, d, 0.0, 1e-3, tmax, any_hit)
    n0 = mtk.LAUNCHES
    hk = mtk.brute_trace(card, o.to(dev), d.to(dev), 0.0, 1e-3,
                         tmax.to(dev), any_hit)
    torch.cuda.synchronize()
    T = host.geom.face_v.shape[0]
    assert mtk.LAUNCHES == n0 + _mt_launches(dev, R, T)
    assert int((hp.tri >= 0).sum()) > R // 20
    _assert_hits_equal(hk, hp)


def test_mt_kernel_rejects_bad_inputs(dev):
    o, d, p0, p1, p2, valid, tmin, tmax = (
        torch.from_numpy(x).to(dev) for x in triangle_soup(64, 32, 1)[:-1])
    with pytest.raises(ValueError):
        mtk.launch(o.double(), d, p0, p1, p2, valid, tmin, tmax)
    with pytest.raises(ValueError):
        mtk.launch(o, d, p0, p1, p2, valid.long(), tmin, tmax)
    with pytest.raises(ValueError):
        mtk.launch(o, d, p0.cpu(), p1, p2, valid, tmin, tmax)


def _assert_grads_close(got, want):
    """Loss within rtol 1e-4; each leaf within rtol 1e-3 and atol 1e-4 x
    max|leaf| of the CPU's (scatter sums in another order, and the card's
    transcendental functions differ from the CPU's by an ulp)."""
    (lg, gg), (lw, gw) = got, want
    np.testing.assert_allclose(float(lg), float(lw), rtol=1e-4)
    for k in ts.PARAM_KEYS:
        g, w = gg[k].cpu().numpy(), gw[k].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), k
        atol = 1e-4 * (float(np.abs(w).max()) if w.size else 0.0)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=k)


@pytest.mark.parametrize('intersector', ['auto', 'pallas'])
def test_loss_and_grads_on_card_match_cpu(dev, intersector):
    """One fwd+bwd step of the 12-sphere sponza_standin at 32x24, 3
    bounces, against bench.py's zero target: the card (kernels) against
    the CPU (plain versions); then an Adam step on the card."""
    host, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                        n_spheres=12, intersector=intersector)
    key = rng.PRNGKey(5)
    target = torch.zeros((24, 32, 3))
    want = ts.loss_and_grads_scanned(ts.get_params(host), host, cam, st,
                                     target, key)
    card, cam_d = host.to(dev), cam.to(dev)
    params = ts.get_params(card)
    mod = ck if intersector == 'auto' else mtk
    n0, c0 = mod.LAUNCHES, ct.CALLS + tmt.CALLS
    got = ts.loss_and_grads_scanned(params, card, cam_d, st, target.to(dev),
                                    key)
    torch.cuda.synchronize()
    assert mod.LAUNCHES > n0 and ct.CALLS + tmt.CALLS == c0
    _assert_grads_close(got, want)
    v0 = params['vertices'].clone()
    params, loss = ts.train_step(params, ts.make_optimizer(params, lr=1e-3),
                                 card, cam_d, st, target.to(dev), key)
    assert bool(torch.isfinite(loss)) and not torch.equal(
        params['vertices'], v0)


def test_remat_step_on_card_matches_plain(dev):
    """RenderSettings.remat on the card: one fwd+bwd step of the
    12-sphere sponza_standin at 256x192, 3 bounces, in one tile, against
    the plain step of the same key under _assert_grads_close's rule (the
    backward's atomic scatter sums differ between runs); the forward
    pass launches as without remat and the replay as much again; the
    peak memory above the step's start is lower."""
    scene, cam, st = registry.sponza_standin(256, 192, max_bounces=3,
                                             n_spheres=12, device=dev)
    assert st.ray_tile >= 256 * 192
    target = torch.zeros((192, 256, 3), device=dev)
    out = {}
    for remat in (False, True):
        counters.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        loss, grads = ts.loss_and_grads_scanned(
            ts.get_params(scene), scene, cam,
            dataclasses.replace(st, remat=remat), target, rng.PRNGKey(5))
        torch.cuda.synchronize()
        out[remat] = ((loss.cpu(), {k: g.cpu() for k, g in grads.items()}),
                      torch.cuda.max_memory_allocated(dev) - base,
                      counters.read(), dict(counters.RECOMPUTE))
    (got, peak, fwd, replay), (want, peak0, fwd0, _) = out[True], out[False]
    _assert_grads_close(got, want)
    assert fwd == fwd0 and fwd['launches.cluster_trace'] > 0
    assert replay['launches.cluster_trace'] == fwd['launches.cluster_trace']
    # the replay redraws each bounce step's numbers with the kernel: all
    # the forward pass's draws but the camera's one, made before the steps
    assert replay['launches.threefry'] == fwd['launches.threefry'] - 1 > 0
    assert replay['steps'] > 0 and fwd['calls.cluster_trace'] == 0
    assert peak < peak0


# ------------------------------------------------ the group walk's edges
def _walk_rays(table, bb, box, dev, seed):
    """R rays for a synthetic table: a quarter around its box, half aimed
    at its triangles, a quarter lying in level-1 group boxes' face planes;
    per lane of each 32-ray warp, every 3rd dead, every 3rd of the rest
    with a short any-hit reach (it stops early or misses), the others far;
    random shutter times -> CUDA tensors (o, d, time, tmin, tmax)."""
    o, d = np.concatenate([box_rays(*box, R // 4, seed),
                           table_rays(table, R // 2, seed + 1),
                           grazing_rays(bundle.group_levels(
                               bb.cpu(), ct.GROUP, 1)[0], R // 4, seed + 2)],
                          1)
    lane = np.arange(R)
    tmax = np.where(lane % 3 == 0, -1.0, np.where(lane % 3 == 1, 2.5, 1e12))
    time = np.random.default_rng(seed + 3).uniform(size=R)
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=dev).contiguous()
    return f(o), f(d), f(time), f(np.full(R, 1e-3)), f(tmax)


WALK_MODES = {'nearest': (False, False), 'cheap_any': (True, False),
              'need_ab': (False, True)}


@pytest.mark.parametrize('mb', [False, True])
@pytest.mark.parametrize('mode', sorted(WALK_MODES))
@pytest.mark.parametrize('M', [7, 9, 63, 65, 513, 4100])
def test_cluster_walk_matches_plain(dev, M, mode, mb):
    """The cluster kernel's warp walk against the plain walk, bit for bit
    (t, tri, a, b), in every mode and in the `mb` instantiation (its 76 KB
    of buffers), on synthetic tables whose row counts are not multiples
    of 8, 64 or 512 (4,100: the linear top level over 9 groups), with
    padding rows inside and rows of 1 to 128 lanes; dead, live and
    early-done any-hit lanes share every warp."""
    any_hit, need_ab = WALK_MODES[mode]
    host = cluster_table(M, M, mb=mb)
    card = host.to(dev)
    bb = torch.cat([card.bb_min.T, card.bb_max.T])
    real = card.tri[:, 0] >= 0
    box = (card.bb_min[real].amin(0).cpu(), card.bb_max[real].amax(0).cpu())
    o, d, time, tmin, tmax = _walk_rays(host, bb, box, dev, M)
    time = time if mb else None
    want = ct.trace_ids(card, o, d, tmin, tmax, any_hit, time, need_ab)
    n0 = ck.LAUNCHES
    got = ck.launch(card, o, d, tmin, tmax, any_hit, time, mb, need_ab)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == n0 + 1
    assert int((want[1] >= 0).sum()) > R // 20
    for g, w, f in zip(got, want, ('t', 'tri', 'a', 'b')):
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                          err_msg=f)


@pytest.mark.parametrize('mode', sorted(WALK_MODES))
@pytest.mark.parametrize('n_inst', [7, 65, 600])
def test_icluster_walk_matches_plain(dev, n_inst, mode):
    """The hierarchical kernel's instance and prototype walks against the
    plain walk, bit for bit (t, tri, inst, a, b), in every mode, with
    instance counts that are not multiples of 8, 64 or 512 and prototypes
    of 1, 8, 9 and 128 clusters; dead, live and early-done any-hit lanes
    share every warp."""
    any_hit, need_ab = WALK_MODES[mode]
    host = instanced_table(n_inst, (1, 8, 9, 128), n_inst)
    card = host.to(dev)
    real = card.ibb[0] < 1e37
    box = (card.ibb[:3, real].amin(1).cpu(), card.ibb[3:, real].amax(1).cpu())
    o, d, _, tmin, tmax = _walk_rays(host, card.ibb, box, dev, n_inst)
    want = ict.trace_ids(card, o, d, tmin, tmax, any_hit, need_ab)
    n0 = ick.LAUNCHES
    got = ick.launch(card, o, d, tmin, tmax, any_hit, need_ab)
    torch.cuda.synchronize()
    assert ick.LAUNCHES == n0 + 1
    assert int((want[1] >= 0).sum()) > R // 10
    for g, w, f in zip(got, want, ('t', 'tri', 'inst', 'a', 'b')):
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                          err_msg=f)


# the segment kernel's tables: (instances, prototype rows); the pool's real
# rows fit in shared memory (the resident route) or not (staged per warp)
SEGMENT_TABLES = {'resident_65': (65, (1, 2, 3)),
                  'resident_3400': (3400, (1, 2, 5)),
                  'staged_65': (65, (1, 2, 3, 4, 5, 6, 7, 8)),
                  'staged_600': (600, (8, 8, 8, 8, 5)),
                  'staged_2600': (2600, (1, 5, 8))}


def _segment_rays(host, card, dev, seed):
    """_walk_rays of a segment table (grazing its level-1 group boxes),
    with two warp patterns in front: 16 warps of one ray repeated on all
    32 lanes (every lane wants every row: each tests its own ray), and 16
    warps with lane 0 alone live (a single wanting lane: the cooperative
    test)."""
    E = host.num_entries
    box = (host.sbb[:3, :E].amin(1), host.sbb[3:, :E].amax(1))
    o, d, _, tmin, tmax = _walk_rays(host, card.sbb[:, :E], box, dev, seed)
    lane = torch.arange(1024, device=dev)
    # rays aimed at the table's triangles, each repeated over a warp
    o[:512], d[:512] = o[1024:1536:32].repeat_interleave(32, 0), \
        d[1024:1536:32].repeat_interleave(32, 0)
    tmax[:512] = 1e12
    tmax[512:1024] = torch.where(lane[512:] % 32 == 0, 1e12, -1.0)
    return o, d, tmin, tmax


@pytest.mark.parametrize('mode', sorted(WALK_MODES))
@pytest.mark.parametrize('table', sorted(SEGMENT_TABLES))
def test_iseg_walk_matches_plain(dev, table, mode):
    """The segment kernel's warp walk, on both routes of the pool into
    shared memory, against the plain walk, bit for bit (t, tri, inst, a,
    b), in every mode: segment tables that are not multiples of 8, 64 or
    4,096 (2,600 and 3,400 instances: over 4,096 segments, a linear top
    level of 2 groups, on either route), prototypes of 1-8 rows with padding rows, rows of 1 to 128
    real lanes; a warp of one ray on every lane, a warp with one live lane,
    and warps where dead, live and early-done any-hit lanes mix."""
    any_hit, need_ab = WALK_MODES[mode]
    n_inst, protos = SEGMENT_TABLES[table]
    host = segment_table(n_inst, protos, n_inst)
    card = host.to(dev)
    _, n_slots = isk.pool_slots(isk.row_lanes(host.tri), host.tri.shape[1])
    assert (n_slots > 0) == table.startswith('resident')
    o, d, tmin, tmax = _segment_rays(host, card, dev, n_inst)
    want = ist.trace_ids(card, o, d, tmin, tmax, any_hit, need_ab)
    n0 = isk.LAUNCHES
    got = isk.launch(card, o, d, tmin, tmax, any_hit, need_ab)
    torch.cuda.synchronize()
    assert isk.LAUNCHES == n0 + 1
    assert int((want[1] >= 0).sum()) > R // 20
    assert int((want[1][:512] >= 0).sum()) > 32
    for g, w, f in zip(got, want, ('t', 'tri', 'inst', 'a', 'b')):
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                          err_msg=f)


# the MT kernel's cases: (triangles, rays, split grid?)
MT_CASES = {'T1': (1, R, True), 'T100_one_tile': (100, R, True),
            'T1000': (1000, R + 37, True), 'T4133_split': (4133, R, True),
            'T4133_unsplit': (4133, R + 37, False)}


@pytest.mark.parametrize('case', sorted(MT_CASES))
def test_mt_kernel_grids(dev, case, monkeypatch):
    """The MT kernel bit for bit with its plain version (t, tri, a, b) on
    soups of 1, 100 (less than a tile), 1,000 and 4,133 triangles (not
    multiples of the tile), R and R + 37 rays (not a multiple of the
    block's 512), on a split grid, whose exact ties (the soup's last 64
    triangles repeat its first 64) lie in different ranges, and on an
    unsplit one; the first 1,024 rays dead (two blocks that leave at
    once), and negative t allowed on every 5th ray."""
    T, n, split = MT_CASES[case]
    if not split:
        monkeypatch.setattr(mtk, 'FILL', 0)
    o, d, p0, p1, p2, valid, tmin, tmax, _ = triangle_soup(
        max(T, 64 + 1), n, seed=T)
    p0, p1, p2, valid = p0[:T], p1[:T], p2[:T], valid[:T]
    if T < mtk.TILE:
        valid[:] = 1      # the soup's padding lanes start at id 0
    tmin[::5] = -np.inf
    tmin[:1024], tmax[:1024] = 1e-3, -1.0
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (o, d, p0, p1, p2, valid, tmin, tmax)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = mtk.split(n, T, sms)
    assert (per < T) == (split and T > mtk.TILE)
    want = tmt.mt_trace(*args)
    got = mtk.mt_trace(*[x.to(dev) for x in args])
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) > 0
    for g, w, f in zip(got, want, ('t', 'tri', 'a', 'b')):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=f)
    assert (got[1].cpu()[:1024] == -1).all()


# --------------------------------- edge gradients and adaptive rendering
EDGE_CASES = {
    # scene (the wavefront sort off), its edge terms
    'sponza_12': (lambda: cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                              n_spheres=12, sort_rays=False),
                  ('primary', 'gi')),
    'triangle_sphere': (lambda: cpu(registry.triangle_sphere, size=32,
                                    sort_rays=False), ('primary', 'shadow')),
    'instanced_teapots': (lambda: cpu(registry.instanced_teapots_standin, 32,
                                      24, sort_rays=False), ('primary',)),
}


@pytest.mark.parametrize('name', sorted(EDGE_CASES))
def test_edge_grads_on_card_match_cpu(dev, name):
    """Each boundary term's samples on the card (kernels) against the CPU
    (plain versions), the same key and adjoint (the CPU's render of a
    black target's loss): the same edges and positions; at most 5% of the
    samples with a side radiance that took another path or accepted on
    one device only, at least 90% of the nonzero samples kept, and the
    gradient of those kept within rtol 1e-3 and atol 1e-4 x max|term|
    (the card's index_add_ sums in no fixed order). The wavefront sort is
    off, as in test_adaptive_on_card_matches_cpu."""
    from raytracer_tpu_torch.diff import edges as ed

    samplers = dict(
        primary=(ed.primary_edge_samples, 1024),
        shadow=(lambda *a: ed.EdgeSamples.cat(ed.shadow_edge_samples(*a)),
                1024),
        gi=(ed.gi_edge_samples, 8192))
    make, terms = EDGE_CASES[name]
    host, cam, st = make()
    s, dL, keys = ed.edge_adjoint(ts.get_params(host), host, cam, st,
                                  torch.zeros((st.height, st.width, 3)),
                                  rng.PRNGKey(8))
    card, cam_d, dL_d = s.to(dev), cam.to(dev), dL.to(dev)
    kernel = ck if host.single_level else isk
    for term in terms:
        fn, n = samplers[term]
        want = fn(s, cam, st, dL, keys[term], n)
        n0, c0 = kernel.LAUNCHES, ct.CALLS + ist.CALLS
        got = fn(card, cam_d, st, dL_d, keys[term], n)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES > n0 and ct.CALLS + ist.CALLS == c0
        assert bool(torch.isfinite(got.scal).all())
        assert bool((want.scal != 0).any()), term
        out, kept, excess = edge_sample_parity(got, want, s.geom.vertices)
        assert out <= 0.05 * n, (term, out)
        assert kept >= 0.9 * int((want.scal != 0).sum()), (term, kept)
        assert excess <= 0.0, (term, excess)


@pytest.mark.parametrize('ray_tile', [96, 2048])
def test_adaptive_on_card_matches_cpu(dev, ray_tile):
    """render_adaptive of the 12-sphere sponza_standin at 32x24, 2 bounces,
    levels 1-3: the card against the CPU with the render rule, and equal
    sample counts on >= 99% of pixels; in 96-pixel tiles of one chunk, and
    in one 2048-pixel tile of two 1024-pixel chunks. The wavefront sort is
    off: with it on, a path that turns on an ulp-level sin/cos difference
    hands the rest of its chunk other random numbers, and over a level's
    many integrator calls that moves a few percent of the pixels."""
    host, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=2,
                        n_spheres=12, ray_tile=ray_tile, min_subdivs=2,
                        max_subdivs=3, noise_threshold=0.05,
                        sort_rays=False)
    key = rng.PRNGKey(9)
    img_c, cnt_c = rt.render_adaptive(host, cam, st, key, with_counts=True)
    n0 = ck.LAUNCHES
    img_g, cnt_g = rt.render_adaptive(host.to(dev), cam.to(dev), st, key,
                                      with_counts=True)
    torch.cuda.synchronize()
    assert ck.LAUNCHES > n0
    got, want = img_g.cpu().numpy(), img_c.numpy()
    d = np.abs(got - want)
    assert (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
    assert d.mean() < 1e-3 * np.abs(want).mean()
    assert (cnt_g.cpu() == cnt_c).double().mean() >= 0.99
    assert set(np.unique(cnt_c.numpy())) <= {5, 14}


def test_stone_bake_on_card_matches_cpu(dev):
    from raytracer_tpu_torch.shading import procedural

    got = procedural.bake_stone_texture(num_cells=40, size=128, device=dev)
    want = procedural.bake_stone_texture(num_cells=40, size=128,
                                         device='cpu')
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------ the wide-BVH kernel
BVH_SCENES = {
    'triangle_sphere': (registry.triangle_sphere, dict(size=8)),
    'sponza_full': (registry.sponza_standin, dict(width=32, height=24)),
    'teapots': (registry.instanced_teapots_standin, dict(width=8, height=8)),
    'grid_2000': (registry.instanced_grid_standin, dict(width=8, height=8,
                                                        n=2000)),
    'mb_bullet': (registry.mb_bullet_standin, dict(size=8)),
    'alpha_leaf': (registry.alpha_leaf_standin, dict(size=8)),
    'final_forest_2': (registry.final_forest_standin, dict(
        width=8, height=8, n_trees=2, n_flowers=6, grass_grid=3)),
    'mb_proto': (registry.mb_prototype_standin, dict(size=8, grid=2, rings=6,
                                                     segs=10)),
    'ties': (filled_scene, dict(fill=tie_scene)),
}


@pytest.fixture(scope='module', params=sorted(BVH_SCENES))
def bvh_scene(request, dev):
    make, kw = BVH_SCENES[request.param]
    host = cpu(make, bvh=True, **kw)[0]
    return request.param, host, host.to(dev)


@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_kernel_matches_plain(bvh_scene, dev, any_hit):
    """Every mode the scene has (two levels, motion blur, alpha maps inside
    the walk) with the counters: t, tri, inst, a, b and the box and
    triangle counts bit for bit; the tie scene's duplicated triangles
    decided alike."""
    name, host, card = bvh_scene
    o, d, tm, dist = scene_rays(host, 2 * R, 5)
    tmin, tmax = ray_bounds(dist, any_hit)
    t = torch.from_numpy
    hp, sp = ttr.bvh_trace(card, *(t(x).to(dev) for x in (o, d, tm, tmin,
                                                          tmax)),
                           any_hit=any_hit, collect_stats=True)
    n0, c0 = bvk.LAUNCHES, ttr.CALLS
    hk, sk = bvk.bvh_trace(card, *(t(x).to(dev) for x in (o, d, tm, tmin,
                                                          tmax)),
                           any_hit=any_hit, collect_stats=True)
    torch.cuda.synchronize()
    assert bvk.LAUNCHES == n0 + 1 and ttr.CALLS == c0
    assert int((hp.tri >= 0).sum()) > R // 8
    for f in ('t', 'tri', 'inst', 'a', 'b'):
        assert torch.equal(getattr(hk, f), getattr(hp, f)), f
    for k in ('ray_aabb', 'ray_tri'):
        assert torch.equal(sk[k], sp[k]), k
    # the plain version on the card is the plain version on the CPU
    hc = ttr.bvh_trace(host, t(o), t(d), t(tm), t(tmin), t(tmax), any_hit)
    assert torch.equal(hc.tri, hp.tri.cpu())
    if name == 'ties' and not any_hit:
        assert int(torch.isin(hk.tri.cpu(), torch.arange(6)).sum()) > 20


def test_bvh_kernel_refuses_a_deep_stack(dev):
    """A BVH whose stack bound exceeds the kernel's fixed stack raises
    before the launch; it is never cut short."""
    import dataclasses
    host = cpu(registry.triangle_sphere, size=8, bvh=True)[0]
    card = host.to(dev)
    deep = dataclasses.replace(card, blas=dataclasses.replace(
        card.blas, depth=(bvk.STACK - 4 - 16) // 3 + 1))
    assert ttr.stack_bound(deep.blas) > bvk.STACK
    o = torch.zeros(4, 3, device=dev)
    d = torch.ones(4, 3, device=dev)
    n0 = bvk.LAUNCHES
    with pytest.raises(ValueError, match='stack'):
        bvk.bvh_trace(deep, o, d, 0.0, 1e-3, 1e12)
    assert bvk.LAUNCHES == n0
    ok = dataclasses.replace(card, blas=dataclasses.replace(
        card.blas, depth=(bvk.STACK - 4 - 16) // 3))
    assert ttr.stack_bound(ok.blas) <= bvk.STACK
    bvk.bvh_trace(ok, o, d, 0.0, 1e-3, 1e12)
    assert bvk.LAUNCHES == n0 + 1


def test_bvh_render_on_card_matches_cpu(dev):
    """intersector 'bvh' (and 'auto' on a motion-blurred prototype): every
    trace through the kernel, the image held as the other renders."""
    import dataclasses
    for scene, cam, st in (
            cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                n_spheres=12, bvh=True),
            cpu(registry.instanced_teapots_standin, 32, 24, bvh=True)):
        st = dataclasses.replace(st, intersector='bvh')
        key = rng.PRNGKey(12)
        want = rt.render(scene, cam, st, key).numpy()
        n0, c0 = bvk.LAUNCHES, ttr.CALLS
        got = rt.render(scene.to(dev), cam.to(dev), st, key)
        torch.cuda.synchronize()
        assert bvk.LAUNCHES > n0 and ttr.CALLS == c0
        d = np.abs(got.cpu().numpy() - want)
        assert (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean() >= 0.99
        assert d.mean() < 1e-3 * np.abs(want).mean()
    mb = cpu(registry.mb_prototype_standin, size=8, grid=2, rings=6,
             segs=10)[0]
    o, d, tm, _ = scene_rays(mb, R, 6)
    from raytracer_tpu_torch.render import integrator
    n0 = bvk.LAUNCHES
    h = integrator.trace_fn(mb.to(dev), rt.RenderSettings())(
        *(torch.from_numpy(x).to(dev) for x in (o, d, tm)), 1e-3, 1e12,
        False)
    assert bvk.LAUNCHES == n0 + 1 and bool((h.tri >= 0).any())


def test_ring_on_one_card_matches_replicated(dev, tmp_path):
    """Two gloo ranks on the one card (the hop through host memory): every
    ring round a launch of the cluster kernel on each rank, t bit for bit
    with the kernel on the whole table, tri equal except at exact ties."""
    import json
    from raytracer_tpu_torch.parallel import worker
    kw = dict(width=32, height=24, n_spheres=12)
    sp, _, _ = cpu(registry.sponza_standin, **kw)
    o, d, tm, dist = scene_rays(sp, R, 9)
    tmin, tmax = ray_bounds(dist, False)
    np.savez(tmp_path / 'rays.npz', o=o, d=d, time=tm, tmin=tmin, tmax=tmax)
    res = worker.launch(2, ['--scene', 'sponza_standin', '--scene-kw',
                            json.dumps(kw), '--tasks', 'ring', '--rays',
                            tmp_path / 'rays.npz'],
                        str(tmp_path / 'out.npz'), device='cuda',
                        backend='gloo', timeout=300)
    card = sp.to(dev)
    want = ck.cluster_trace(card, *(torch.from_numpy(x).to(dev) for x in (
        o, d, tm, tmin, tmax)))
    np.testing.assert_array_equal(res['ring/t'], want.t.cpu().numpy())
    ties = res['ring/tri'] != want.tri.cpu().numpy()
    assert ties.sum() <= R // 100
    for s in json.loads(str(res['stats'])):
        g = s['ring']
        assert g['launches']['cluster_trace'] == g['ring_rounds'] > 0
        assert g['plain_calls'] == 0 and g['hops'] == g['ring_rounds']


def test_nccl_one_rank_step_matches_meshless(dev, tmp_path):
    """One NCCL rank: loss_and_grads_scanned(mesh) against the mesh-less
    step on the card (the one rank's all_reduce adds nothing)."""
    import json
    from raytracer_tpu_torch.parallel import worker
    kw = dict(width=32, height=24, max_bounces=3, n_spheres=12)
    res = worker.launch(1, ['--scene', 'sponza_standin', '--scene-kw',
                            json.dumps(kw), '--tasks', 'step', '--tile',
                            256], str(tmp_path / 'out.npz'), device='cuda',
                        backend='nccl', timeout=300)
    scene, cam, st = registry.sponza_standin(**kw, device=dev)
    loss, grads = ts.loss_and_grads_scanned(
        ts.get_params(scene), scene, cam, st,
        torch.zeros((24, 32, 3), device=dev), rng.PRNGKey(7), tile=256)
    np.testing.assert_allclose(res['step/loss'], float(loss), rtol=1e-6)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(res[f'step/grad/{k}'],
                                   grads[k].cpu().numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    assert json.loads(str(res['stats']))[0]['step']['reduces'] == 1


XLA_SCENES = {
    'sponza_12': (registry.sponza_standin, dict(width=32, height=24,
                                                n_spheres=12)),
    'mb_bullet': (registry.mb_bullet_standin, dict(size=8)),
    'alpha_leaf': (registry.alpha_leaf_standin, dict(size=8)),
}


@pytest.mark.parametrize('name', sorted(XLA_SCENES))
def test_xla_cluster_on_card_matches_cpu(dev, name, monkeypatch):
    """intersector 'cluster' (ops/cluster_trace.xla_cluster_trace, plain
    PyTorch on either device; motion blur and alpha inside the sweep) on
    the card against the CPU on the same rays, the CPU's in two ray
    chunks: the same float32 operations in the same order, so t, tri, a
    and b bit for bit, nearest and any-hit, and no kernel launched."""
    from raytracer_tpu_torch import RenderSettings
    from raytracer_tpu_torch.render import integrator
    make, kw = XLA_SCENES[name]
    host, _, _ = cpu(make, **kw)
    card = host.to(dev)
    o, d, tm, dist = scene_rays(host, R, 12)
    for any_hit in (False, True):
        rays = [torch.from_numpy(x) for x in (o, d, tm,
                                             *ray_bounds(dist, any_hit))]
        with monkeypatch.context() as m:
            m.setattr(ct, 'CHUNK_BYTES', 16 * host.clusters.num_clusters
                      * (R // 2))
            want = ct.xla_cluster_trace(host, *rays, any_hit)
        n0 = ck.LAUNCHES
        got = integrator.trace_fn(card, RenderSettings(
            intersector='cluster'))(*(x.to(dev) for x in rays), any_hit)
        assert ck.LAUNCHES == n0
        for f in ('t', 'tri', 'a', 'b'):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        assert int((want.tri >= 0).sum()) > R // 20


# ------------------------------------------------ the threefry kernel
# sizes from one output to the bounce loop's (2^21, 3) draw, none of the
# odd ones a whole number of the kernel's four outputs a thread
THREEFRY_SHAPES = [(1,), (3,), (5,), (1023,), (4097,), (1 << 21, 3)]
# uniform_segmented's layouts: (R, k) in runs along axis 0 (the bounce
# loop) and (num_samples, R, 2) along axis 1 (the lights' NEE)
THREEFRY_SEGMENTED = [((4096, 3), 1024, 0), ((1 << 21, 2), 1 << 19, 0),
                      ((1, 4096, 2), 1024, 1), ((3, 1 << 21, 2), 1 << 19, 1),
                      ((2, 96, 5), 32, 1)]
THREEFRY_KEYS = [rng.PRNGKey(0), rng.fold_in(rng.PRNGKey(-3), 77)]


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize('shape', THREEFRY_SHAPES)
def test_threefry_kernel_matches_plain(dev, shape):
    """uniform and random_bits of a host key on the card: one launch each,
    bit for bit with the plain int64 version on the same card."""
    for key in THREEFRY_KEYS:
        n0 = rk.LAUNCHES
        _same_bits(rng.uniform(key, shape, dev),
                   rng.plain_uniform(key, shape, dev))
        _same_bits(rng.random_bits(key, shape, dev),
                   rng.plain_bits(key, shape, dev))
        assert rk.LAUNCHES == n0 + 2


@pytest.mark.parametrize('shape,segment,axis', THREEFRY_SEGMENTED)
def test_threefry_kernel_segmented_matches_plain(dev, shape, segment, axis):
    for key in THREEFRY_KEYS:
        _same_bits(rng.uniform_segmented(key, shape, segment, axis, dev),
                   rng.plain_uniform(key, shape, dev, segment, axis))


def test_threefry_kernel_batch_keys_match_plain(dev):
    """fold_in of a tensor (a batch of keys, render_adaptive's per-pixel
    keys), split and fold_in of such a batch, and uniform and random_bits
    per key, against the plain version on the same card."""
    base = rng.fold_in(rng.PRNGKey(9), 4)
    for ids in (torch.arange(0, 3001, 3, dtype=torch.int32, device=dev),
                torch.tensor([0, 1, 2 ** 31 - 1, -1, -7], device=dev)):
        keys, want = rng.fold_in(base, ids), rng.plain_fold_in(base, ids)
        _same_bits(keys.k1, want.k1)
        _same_bits(keys.k2, want.k2)
        for got, ref in zip(rng.split(keys, 3) + (rng.fold_in(keys, 7),),
                            [rng.plain_fold_in(want, i) for i in range(3)]
                            + [rng.plain_fold_in(want, 7)]):
            _same_bits(got.k1, ref.k1)
            _same_bits(got.k2, ref.k2)
        for shape in ((5,), (1,), (2, 3)):
            _same_bits(rng.uniform(keys, shape), rng.plain_uniform(want, shape,
                                                                   dev))
            _same_bits(rng.random_bits(keys, shape),
                       rng.plain_bits(want, shape, dev))


def test_no_card_draw_reaches_the_int64_version(dev, monkeypatch):
    """On the card every draw and fold_in of a tensor is the kernel's: the
    int64 block is never called, in a render or in randint; a refused
    launch and a key of the wrong type raise."""
    def int64_block(k1, k2, x1, x2):
        if any(isinstance(v, torch.Tensor) for v in (k1, k2, x1, x2)):
            raise AssertionError('the int64 threefry ran on tensors')
        return block(k1, k2, x1, x2)
    block = rng._threefry2x32
    monkeypatch.setattr(rng, '_threefry2x32', int64_block)
    scene, cam, st = registry.sponza_standin(32, 24, max_bounces=2,
                                             n_spheres=12, device=dev)
    counters.reset()
    img = rt.render(scene, cam, st, rng.PRNGKey(1))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all()) and rk.LAUNCHES > 0
    assert rk.MODES['uniform'] == rk.LAUNCHES
    rng.randint(rng.PRNGKey(2), (1001,), 0, 777, dev)
    rng.uniform(rng.fold_in(rng.PRNGKey(3), torch.arange(9, device=dev)),
                (5,))
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match='CUDA error'):
        rk._launch('uniform', (0, 0, None, None), 10, 3, dev,
                   torch.empty(10, device=dev))
    with pytest.raises(ValueError, match='int64'):
        rk.draw(torch.zeros(3, dtype=torch.int32, device=dev),
                torch.zeros(3, dtype=torch.int32, device=dev), (2,), dev)


# ------------------------------------------------ the take-scatter kernel
# (kind, rows M, channels C, index columns K, index rows N): random rows,
# sorted runs (a Morton-sorted wavefront's corners), every index on one row
# (M = 1) and a permutation; small tables take table_shared, the 100,000-row
# ones table_global
TAKE_CASES = [('random', 40, 3, 1, 5000), ('random', 100_000, 3, 3, 70_001),
              ('sorted', 40, 1, 1, 300_001), ('sorted', 100_000, 3, 3, 9000),
              ('sorted', 5000, 1, 16, 4097), ('one_row', 1, 3, 1, 100_000),
              ('one_row', 1, 1, 3, 33), ('permutation', 3000, 3, 1, 3000),
              ('permutation', 200_000, 1, 1, 200_000)]


def _take_case(kind, M, C, K, N, dtype, dev, seed=0):
    """(grad (N, K, C) float32, idx (N, K)) on the card."""
    rs = np.random.default_rng(seed)
    if kind == 'permutation':
        idx = rs.permutation(M).reshape(N, K)
    elif kind == 'one_row':
        idx = np.zeros((N, K), np.int64)
    else:
        idx = rs.integers(0, M, (N, K))
        if kind == 'sorted':
            idx = np.sort(idx, axis=0)
    grad = rs.normal(size=(N, K, C)).astype(np.float32)
    return (torch.from_numpy(grad).to(dev),
            torch.from_numpy(idx).to(dtype).to(dev))


def _hold_to_index_add(got, grad, idx, M):
    """|kernel - index_add_| <= 1e-5 x the sum of |contributions| at each
    entry: the two sum each entry in other orders (index_add_'s atomics in
    an order that changes from run to run)."""
    C = grad.shape[-1]
    flat = idx.reshape(-1).long()
    want = torch.zeros((M, C), device=grad.device).index_add_(
        0, flat, grad.reshape(-1, C))
    mag = torch.zeros((M, C), dtype=torch.float64,
                      device=grad.device).index_add_(
        0, flat, grad.reshape(-1, C).abs().double())
    excess = (got.double() - want.double()).abs() - 1e-5 * mag
    assert float(excess.max()) <= 0.0, float(excess.max())


@pytest.mark.parametrize('dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('case', TAKE_CASES)
def test_take_scatter_kernel_matches_index_add(dev, case, dtype):
    kind, M, C, K, N = case
    grad, idx = _take_case(kind, M, C, K, N, dtype, dev)
    n0, mode = tk.LAUNCHES, tk.mode(M, C)
    modes0 = tk.MODES[mode]
    got = tk.scatter(grad, idx, M)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == n0 + 1 and tk.MODES[mode] == modes0 + 1
    assert got.shape == (M, C) and got.dtype == torch.float32
    _hold_to_index_add(got, grad, idx, M)


def test_take_scatter_kernel_edges(dev):
    """Both modes are taken; no index launches nothing; wrong inputs and
    a float64 gradient through take on the card raise."""
    assert tk.mode(40, 3) == 'table_shared'
    assert tk.mode(100_000, 3) == 'table_global'
    n0 = tk.LAUNCHES
    out = tk.scatter(torch.zeros((0, 3, 3), device=dev),
                     torch.zeros((0, 3), dtype=torch.int32, device=dev), 7)
    assert tk.LAUNCHES == n0 and out.shape == (7, 3) and not out.any()
    with pytest.raises(ValueError, match='float32'):
        tk.scatter(torch.zeros((4, 1, 3), dtype=torch.float64, device=dev),
                   torch.zeros((4, 1), dtype=torch.int64, device=dev), 2)
    with pytest.raises(ValueError, match='idx'):
        tk.scatter(torch.zeros((4, 1, 3), device=dev),
                   torch.zeros((4, 2), dtype=torch.int64, device=dev), 2)
    with pytest.raises(ValueError, match='CUDA'):
        tk.scatter(torch.zeros((4, 1, 3)), torch.zeros((4, 1)).long(), 2)
    x = torch.ones((5, 3), dtype=torch.float64, device=dev,
                   requires_grad=True)
    y = vm.take(x, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match='float32'):
        y.sum().backward()


def test_step_take_grads_launch_the_kernel_only(dev, monkeypatch):
    """A training step on the card scatters every take gradient with the
    kernel, in both modes: index_add_ never runs there, and the leaves
    agree with the CPU's step within phase 15's rule."""
    def no_index_add(self, *args, **kw):
        if self.is_cuda:
            raise AssertionError('index_add_ ran on the card')
        return index_add(self, *args, **kw)
    index_add = torch.Tensor.index_add_
    host, cam, st = registry.sponza_standin(32, 24, max_bounces=3,
                                            n_spheres=12, device='cpu')
    target = torch.zeros((st.height, st.width, 3))
    want = ts.loss_and_grads_scanned(ts.get_params(host), host, cam, st,
                                     target, rng.PRNGKey(4))
    card = host.to(dev)
    monkeypatch.setattr(torch.Tensor, 'index_add_', no_index_add)
    counters.reset()
    got = ts.loss_and_grads_scanned(ts.get_params(card), card, cam.to(dev),
                                    st, target.to(dev), rng.PRNGKey(4))
    torch.cuda.synchronize()
    assert tk.MODES['table_shared'] > 0 and tk.MODES['table_global'] > 0
    assert tk.LAUNCHES == sum(tk.MODES.values())
    _assert_grads_close((got[0].cpu(), {k: g.cpu() for k, g in
                                        got[1].items()}), want)
