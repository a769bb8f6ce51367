"""The geometry-sharded ring tracer (ops/ring_trace.py) on gloo ranks on
the CPU, against the JAX package's replicated cluster tracer and the
port's own.

* `shard_clusters` byte-equal to the JAX package's for 2 and 3 shards
  (the 3-way cut pads), and `local_shard` the rank's rows of it.
* Intersector 'ring' on 2 and 3 ranks (parallel/worker.py's `ring` task,
  rays from a seed with numpy, every 4th starting at half its distance,
  every 16th dead) against the JAX package's XLA `cluster_trace` on the
  whole table (the JAX ring on one shard: the same near-ordered sweep,
  alpha tested inside it) and the port's replicated tracer of the same
  rule ('auto' where the scene has no alpha maps, 'cluster' where it
  has): `tri` equal except at exact ties in t, which are counted and must
  be few; t within rtol 1e-5 of JAX's (the rule of
  tests/test_sharding.py:225-261) and bit for bit with the port's (the
  same float32 arithmetic: shards change only which rows a ray meets
  first); any-hit rays agree on whether there is a hit. One
  motion-blurred scene (`mb_bullet_standin`) and one with alpha maps
  (`alpha_leaf_standin`: each round the JAX ring's sweep, no alpha march).
* No deadlock: `alpha_leaf_standin` at 8x8 on 4 ranks, where the bottom
  and top ranks' camera rays all see the sky while the middle ranks'
  paths go on and take more traces; render_geometry_sharded finishes,
  every rank traces as often as the others, and the frame equals
  render_sharded's ('cluster', the same alpha rule) of the same run.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu.ops import ring_trace as jring
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import ring_trace as ring
from raytracer_tpu_torch.parallel import worker
from raytracer_tpu_torch.render import integrator
from raytracer_tpu_torch.render.renderer import render_pixels
from raytracer_tpu_torch.scenes import registry

from .test_torch_sharding import TIMEOUT, _chunks
from .torch_port_util import cpu, ray_bounds, scene_rays

# not a multiple of 2 or 3: the worker pads the ranks' shares
R = 385
SCENES = dict(sponza_12=(registry.sponza_standin,
                         dict(width=16, height=12, n_spheres=12)),
              mb_bullet=(registry.mb_bullet_standin, dict(size=8)),
              alpha_leaf=(registry.alpha_leaf_standin, dict(size=8)))
FIELDS = ('bb_min', 'bb_max', 'p0', 'e1', 'e2', 'p0_t1', 'e1_t1', 'e2_t1',
          'tri')


def _scenes(name):
    make, kw = SCENES[name]
    sj, _, st = cpu(make, **kw, builder=rj.SceneBuilder())
    sp, _, _ = cpu(make, **kw)
    return sj, sp, st


@pytest.mark.parametrize('D', [2, 3])
def test_shard_clusters_matches_jax(D):
    sj, sp, _ = _scenes('sponza_12')
    want = jring.shard_clusters(sj.clusters, D)
    got = ring.shard_clusters(sp.clusters, D)
    M = sp.clusters.num_clusters
    assert got.num_clusters == M + (-M) % D
    assert (got.num_clusters > M) == (D == 3)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # a static table keeps one tensor for both poses
    assert got.p0_t1 is got.p0

    class Mesh:
        size, rank = D, D - 1
    shard = ring.local_shard(sp.clusters, Mesh)
    n = got.num_clusters // D
    assert isinstance(shard, ring.Shard) and shard.mesh is Mesh
    for f in FIELDS:
        assert torch.equal(getattr(shard, f), getattr(got, f)[-n:]), f


def _rays(sp, any_hit, seed=5):
    o, d, tm, dist = scene_rays(sp, R, seed)
    tmin, tmax = ray_bounds(dist, any_hit)
    return dict(o=o, d=d, time=tm, tmin=tmin, tmax=tmax)


def _ring_run(name, D, tmp_path):
    """The worker's `ring` task: nearest rays, then the same rays as
    any-hit ones (any-hit bounds: the rays stop at their target)."""
    make, kw = SCENES[name]
    _, sp, _ = _scenes(name)
    near, anyr = _rays(sp, False), _rays(sp, True)
    f = tmp_path / 'rays.npz'
    np.savez(f, **near, any_tmax=anyr['tmax'])
    out = worker.launch(
        D, ['--scene', make.__name__, '--scene-kw', json.dumps(kw),
            '--tasks', 'ring', '--rays', f],
        str(tmp_path / 'out.npz'), device='cpu', timeout=TIMEOUT)
    res = {k: out[f'ring/{k}'] for k in ('t', 'tri', 'a', 'b', 'any_tri')}
    res['stats'] = json.loads(str(out['stats']))
    return near, anyr, res


def _check_ties(t, tri, t_ref, tri_ref, rtol):
    """tri equal but where the two hits' t agree (an exact tie) -> the
    count of such rays."""
    hit = tri_ref >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol)
    ties = int((tri != tri_ref).sum())
    assert ties <= max(2, R // 50), f'{ties} ties'
    return ties


def _jax_trace(sj, any_hit):
    """What the JAX ring computes, replicated: the XLA `cluster_trace`
    on the whole table, alpha tested inside its sweep, as the JAX ring's
    `_local_sweep` tests it on each shard (on 384 rays of
    alpha_leaf_standin that rule finds 123 opaque hits, the alpha march
    of 'cluster_pallas' 94)."""
    return lambda *a: jct.cluster_trace(sj, *a, any_hit)


@pytest.mark.parametrize('name,D', [('sponza_12', 2), ('sponza_12', 3),
                                    ('mb_bullet', 2), ('alpha_leaf', 2)])
def test_ring_matches_replicated(name, D, tmp_path):
    sj, sp, st = _scenes(name)
    near, anyr, res = _ring_run(name, D, tmp_path)
    alpha = sp.has_alpha_maps
    port = integrator.trace_fn(sp, dataclasses.replace(
        st, intersector='cluster' if alpha else 'auto'))
    for rays, any_hit in ((near, False), (anyr, True)):
        want_j = _jax_trace(sj, any_hit)(*(jnp.asarray(rays[k]) for k in (
            'o', 'd', 'time', 'tmin', 'tmax')))
        want_p = port(*(torch.from_numpy(rays[k]) for k in (
            'o', 'd', 'time', 'tmin', 'tmax')), any_hit)
        if any_hit:
            got = res['any_tri'] >= 0
            np.testing.assert_array_equal(got, np.asarray(want_j.tri) >= 0)
            np.testing.assert_array_equal(got, want_p.tri.numpy() >= 0)
            continue
        _check_ties(res['t'], res['tri'], np.asarray(want_j.t),
                    np.asarray(want_j.tri), 1e-5)
        _check_ties(res['t'], res['tri'], want_p.t.numpy(),
                    want_p.tri.numpy(), 0.0)
        same = res['tri'] == want_p.tri.numpy()
        np.testing.assert_array_equal(res['t'], want_p.t.numpy())
        np.testing.assert_allclose(res['a'][same], want_p.a.numpy()[same],
                                   rtol=0, atol=1e-6)
        assert (res['tri'] >= 0).sum() > R // 10, 'too few hits'
    # every rank ran D rounds a ring trace and D hops; a round is the
    # cluster tracer's call, or with alpha maps the JAX ring's sweep
    for s in res['stats']:
        g = s['ring']
        assert g['ring_rounds'] == D * g['ring_traces'] > 0
        assert g['hops'] == g['ring_rounds'] and g['march_passes'] == 0
        rounds = g['sweeps'] if alpha else g['plain_calls']
        assert rounds == g['ring_rounds']
        assert (g['plain_calls'] if alpha else g['sweeps']) == 0


def test_ring_needs_a_single_level_table():
    sp, _, st = cpu(registry.instanced_teapots_standin, 8, 8)
    with pytest.raises(ValueError, match='single-level'):
        ring.RingTracer(sp)


def test_no_deadlock_when_ranks_part(tmp_path):
    """Four ranks over alpha_leaf_standin at 8x8: alone, their chunks would
    trace different counts of times (a chunk of sky stops after its
    first trace; the leaves' paths go on). Under 'ring' every rank takes
    the shared decisions, traces as often as the others, and the frame
    equals the data-parallel one under 'cluster', the same alpha rule."""
    make, kw = SCENES['alpha_leaf']
    kw = dict(kw, intersector='cluster')
    sp, cam, st = cpu(make, **kw)
    traces = []
    for i, (px, py) in enumerate(_chunks(st, 4)):
        n0 = ct.SWEEPS
        render_pixels(sp, cam, st, 1, torch.from_numpy(px),
                      torch.from_numpy(py),
                      rng.fold_in(rng.PRNGKey(7), i))
        traces.append(ct.SWEEPS - n0)
    # the bottom rank: one trace of camera rays that all miss, one of dead
    # shadow rays, then its loop would stop; the leaves' ranks go on
    assert traces[0] == 2 and max(traces) > 2, traces
    res = worker.launch(
        4, ['--scene', make.__name__, '--scene-kw', json.dumps(kw),
            '--tasks', 'render_geometry,render'],
        str(tmp_path / 'out.npz'), device='cpu', timeout=TIMEOUT)
    np.testing.assert_allclose(res['render_geometry/img'], res['render/img'],
                               rtol=1e-4, atol=1e-5)
    stats = [s['render_geometry'] for s in json.loads(str(res['stats']))]
    assert len({(s['ring_traces'], s['march_passes'], s['flags'])
                for s in stats}) == 1, stats
    # no alpha march under 'ring': each round is one sweep of the JAX ring
    assert stats[0]['march_passes'] == 0 and stats[0]['ring_traces'] > 0
    assert stats[0]['sweeps'] == stats[0]['ring_rounds'] \
        == 4 * stats[0]['ring_traces']
