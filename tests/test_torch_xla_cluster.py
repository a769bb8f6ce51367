"""The JAX package's XLA cluster tracer (intersector 'cluster') in the port,
ops/cluster_trace.xla_cluster_trace, against raytracer_tpu's
ops/cluster_trace.cluster_trace on the CPU, and two routing repairs.

* tests/test_cluster.py:38-71 on the stand-in asset tree: `teapot_blinn`,
  `cornell_pt` and `mb_bullet` (motion blur) at size 16, incoherent rays
  from a seed with numpy: tri equal, t within rtol 1e-5, a and b within
  1e-5; any-hit rays (stopped at their target) agree on hit or miss, and
  t on the hits.
* The rays of the full `sponza_proxy(hd=True)` where the card found
  'cluster' and the cluster kernel parting in tri: JAX picks 'cluster''s
  triangle, at a tie of t (exact, or one ulp where triangles meet).
* `alpha_leaf_standin` at 8x8, 384 rays: the XLA tracer tests alpha inside
  its sweep, so its opaque hits are the JAX tracer's 123, ray for ray,
  where the alpha march ('auto', 'cluster_pallas') finds 94.
* Ray chunks and the dropping of settled rays change no result.
* A 16x16, 2-bounce 'cluster' render of `cornell_pt` and `alpha_leaf`
  against the JAX 'cluster' render on the same key, under the image rule
  of tests/test_torch_render.py; `loss_and_grads_scanned` through
  'cluster' equal to 'auto' on an opaque 8x8 scene.
* 'cluster_pallas' routes as 'auto' on single-level scenes, opaque and
  alpha; 'cluster' and 'cluster_pallas' on a two-level scene raise and
  name 'cluster2'.
* The asset root defaults to the JAX registry's when RT_ASSETS is unset,
  wherever HOME points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu.render import renderer as jr
from raytracer_tpu.scenes import registry as jreg
import raytracer_tpu_torch as rt
from raytracer_tpu_torch import RenderSettings
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import integrator
from raytracer_tpu_torch.scenes import registry

from .test_torch_asset_scenes import point_at, tree  # noqa: F401
from .test_torch_render import _assert_images_close
from .torch_port_util import (cpu, jax_camera, jax_settings, random_rays,
                              ray_bounds, scene_rays)

ASSET_SCENES = ('teapot_blinn', 'cornell_pt', 'mb_bullet')
FIELDS = ('t', 'tri', 'inst', 'a', 'b')


def _traces(sj, sp, rays, any_hit):
    """The JAX XLA tracer and the port's 'cluster' on the same rays."""
    want = jct.cluster_trace(sj, *(jnp.asarray(x) for x in rays), any_hit)
    tracer = integrator.trace_fn(sp, RenderSettings(intersector='cluster'))
    calls = ct.SWEEPS
    got = tracer(*(torch.from_numpy(x) for x in rays), any_hit)
    assert ct.SWEEPS == calls + 1
    return want, got


def _hold(want, got, any_hit):
    tri_w, tri = np.asarray(want.tri), got.tri.numpy()
    hit = tri_w >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)
    assert (got.t.numpy()[~hit] == 1e12).all()
    if not any_hit:
        np.testing.assert_array_equal(tri, tri_w)
        for f in ('a', 'b'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-5, err_msg=f)
    assert (got.inst.numpy() == 0).all()


@pytest.mark.parametrize('name', ASSET_SCENES)
def test_cluster_matches_jax(tree, monkeypatch, name):
    point_at(monkeypatch, tree[0])
    sj, _, _ = jreg.make(name, size=16, bvh=True)
    sp, _, _ = registry.make(name, size=16, bvh=True, device='cpu')
    cl = sp.clusters
    o, d, tm, dist = random_rays(cl.bb_min, cl.bb_max, cl.tri, 300, 2)
    lane = np.arange(300)
    tmin = np.where(lane % 4 == 1, 0.5 * dist, 1e-3).astype(np.float32)
    for any_hit, tmax in ((False, 1e12), (True, dist)):
        tmax = np.broadcast_to(np.float32(tmax), (300,)).copy()
        rays = (o, d, tm, tmin, tmax)
        want, got = _traces(sj, sp, rays, any_hit)
        _hold(want, got, any_hit)
        assert (got.tri >= 0).sum() > 30, 'too few hits'


# chip_smoke.py's 32,768 incoherent rays (test_rays: the atrium's box, a
# seed of 2024) on the full sponza_proxy(hd=True): where the card's
# 'cluster' and cluster kernel part in tri (phase 33, H100)
TIE_RAYS = [210, 798, 940, 8729, 9515, 10597, 10708, 25778, 31560]


def test_near_ties_follow_the_jax_tracer(tree, monkeypatch):
    """Where 'cluster' and the cluster kernel pick other triangles, the
    JAX XLA tracer picks 'cluster''s: a tie of t, exact or one ulp apart
    where two triangles meet (the near-ordered sweep stops once the next
    box's key reaches its best t)."""
    point_at(monkeypatch, tree[0])
    rs = np.random.default_rng(2024)
    lo, hi = np.float32([-9.8, 0.05, -4.9]), np.float32([9.8, 7.9, 4.9])
    o = (lo + rs.uniform(size=(32768, 3)) * (hi - lo))[TIE_RAYS]
    d = rs.normal(size=(32768, 3))[TIE_RAYS]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = len(TIE_RAYS)
    rays = (o.astype(np.float32), d.astype(np.float32),
            np.zeros(n, np.float32), np.full(n, 1e-3, np.float32),
            np.full(n, 1e12, np.float32))
    sj, _, _ = jreg.make('sponza_proxy', hd=True)
    sp, _, _ = registry.make('sponza_proxy', hd=True, device='cpu')
    want, got = _traces(sj, sp, rays, False)
    _hold(want, got, False)
    kernel = ct.cluster_trace(sp, *(torch.from_numpy(x) for x in rays))
    assert (kernel.tri != got.tri).all()
    ulps = (got.t - kernel.t).numpy() / np.spacing(kernel.t.numpy())
    assert set(ulps.tolist()) == {0.0, 1.0}, ulps


def _alpha_pair():
    sj, _, st = cpu(registry.alpha_leaf_standin, size=8,
                    builder=rj.SceneBuilder())
    sp, _, _ = cpu(registry.alpha_leaf_standin, size=8)
    return sj, sp, st


def test_alpha_in_sweep_matches_jax():
    """384 rays of alpha_leaf_standin: the JAX XLA tracer's 123 opaque
    hits, ray for ray; the alpha march around the cluster tracer finds 94
    (the JAX package's two alpha rules differ)."""
    sj, sp, _ = _alpha_pair()
    o, d, tm, dist = scene_rays(sp, 384, 5)
    for any_hit in (False, True):
        tmin, tmax = ray_bounds(dist, any_hit)
        want, got = _traces(sj, sp, (o, d, tm, tmin, tmax), any_hit)
        _hold(want, got, any_hit)
        hit = got.tri >= 0
        alpha = isect.alpha_of(sp, got.tri.clamp(min=0), got.a, got.b)
        assert (alpha[hit] >= 0.5).all()
        if not any_hit:
            assert int(hit.sum()) == 123
            march = integrator.trace_fn(sp, RenderSettings())(
                *(torch.from_numpy(x) for x in (o, d, tm, tmin, tmax)),
                False)
            assert int((march.tri >= 0).sum()) == 94


def test_chunks_change_nothing(monkeypatch):
    """Chunks of 37 and of 50 rays (CHUNK_BYTES cut) against one chunk:
    every field equal, nearest and any-hit, and the sweep's live rays
    fall step by step."""
    sp, _, _ = cpu(registry.sponza_standin, 16, 12, n_spheres=12)
    o, d, tm, dist = (torch.from_numpy(x) for x in scene_rays(sp, 500, 3))
    M = sp.clusters.num_clusters
    for any_hit in (False, True):
        tmin, tmax = (torch.from_numpy(x) for x in ray_bounds(dist.numpy(),
                                                              any_hit))
        monkeypatch.setattr(ct, 'SWEEP_LIVE', [])
        whole = ct.xla_cluster_trace(sp, o, d, tm, tmin, tmax, any_hit)
        (live,) = ct.SWEEP_LIVE
        assert len(live) > 2 and live == sorted(live, reverse=True)
        assert live[0] < 500 and live[-1] == 0
        monkeypatch.setattr(ct, 'CHUNK_BYTES', 16 * M * 37)
        small = ct.xla_cluster_trace(sp, o, d, tm, tmin, tmax, any_hit)
        monkeypatch.setattr(ct, 'CHUNK_BYTES', 16 * M * 50)
        chunks = ct.SWEEP_LIVE
        chunks.clear()
        cut = ct.xla_cluster_trace(sp, o, d, tm, tmin, tmax, any_hit)
        monkeypatch.undo()
        assert len(chunks) == 10                 # 500 rays, 50 a chunk
        for f in FIELDS:
            assert torch.equal(getattr(small, f), getattr(whole, f)), f
            assert torch.equal(getattr(cut, f), getattr(whole, f)), f
        assert (whole.tri >= 0).sum() > 50


RENDERS = {
    'cornell_pt': (dict(size=16, max_bounces=2, num_rect_samples=2), 3),
    'alpha_leaf': (dict(size=16, max_bounces=2), 5),
}


@pytest.mark.parametrize('name', sorted(RENDERS))
def test_render_matches_jax(tree, monkeypatch, name):
    point_at(monkeypatch, tree[0])
    kw, key = RENDERS[name]
    sj, _, _ = jreg.make(name, **kw)
    sp, cam, st = registry.make(name, device='cpu', **kw)
    st = dataclasses.replace(st, intersector='cluster')
    want = jr.render(sj, jax_camera(cam), jax_settings(st),
                     jax.random.PRNGKey(key))
    calls, kernel_calls = ct.SWEEPS, ct.CALLS
    got = rt.render(sp, cam, st, rng.PRNGKey(key))
    assert ct.SWEEPS > calls and ct.CALLS == kernel_calls
    _assert_images_close(got.numpy(), np.asarray(want))


def test_loss_and_grads_through_cluster():
    """The trainer takes 'cluster' through trace_fn: on an opaque scene
    its hits are 'auto''s, so are the loss and every gradient."""
    sp, cam, st = cpu(registry.triangle_sphere, size=8)
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(8, 8, 3)).astype(np.float32))
    out = {}
    for mode in ('auto', 'cluster'):
        out[mode] = ts.loss_and_grads_scanned(
            ts.get_params(sp), sp, cam,
            dataclasses.replace(st, intersector=mode), target,
            rng.PRNGKey(6))
    (la, ga), (lc, gc) = out['auto'], out['cluster']
    assert torch.equal(la, lc)
    for k in ts.PARAM_KEYS:
        assert torch.equal(ga[k], gc[k]), k
    assert float(ga['vertices'].abs().max()) > 0


@pytest.mark.parametrize('any_hit', [False, True])
@pytest.mark.parametrize('name', ['sponza_12', 'alpha_leaf'])
def test_cluster_pallas_routes_as_auto(name, any_hit):
    if name == 'alpha_leaf':
        sp = _alpha_pair()[1]
    else:
        sp, _, _ = cpu(registry.sponza_standin, 16, 12, n_spheres=12)
    o, d, tm, dist = scene_rays(sp, 256, 8)
    rays = [torch.from_numpy(x) for x in (o, d, tm, *ray_bounds(dist,
                                                                any_hit))]
    hits = {}
    for mode in ('auto', 'cluster_pallas'):
        calls, passes = ct.CALLS, ct.MARCH_PASSES
        hits[mode] = integrator.trace_fn(
            sp, RenderSettings(intersector=mode))(*rays, any_hit)
        hits[mode + '_calls'] = (ct.CALLS - calls, ct.MARCH_PASSES - passes)
    for f in FIELDS:
        assert torch.equal(getattr(hits['auto'], f),
                           getattr(hits['cluster_pallas'], f)), f
    assert hits['auto_calls'] == hits['cluster_pallas_calls']
    assert (hits['auto_calls'][1] > 0) == sp.has_alpha_maps
    assert (hits['auto'].tri >= 0).sum() > 20


def test_cluster_names_need_a_single_level_scene():
    sp, _, _ = cpu(registry.instanced_teapots_standin, 8, 8)
    for mode in ('cluster', 'cluster_pallas'):
        with pytest.raises(ValueError, match="'cluster2'"):
            integrator.trace_fn(sp, RenderSettings(intersector=mode))


def test_asset_root_defaults_to_the_jax_registry_s(monkeypatch, tmp_path):
    monkeypatch.delenv('RT_ASSETS', raising=False)
    monkeypatch.setenv('HOME', str(tmp_path))
    assert registry.asset_root() == '/root/reference'
    monkeypatch.setenv('RT_ASSETS', str(tmp_path))
    assert registry.asset_root() == str(tmp_path)
