"""The port's several-rank entry points (parallel/sharding.py over
parallel/distributed.py) on gloo ranks on the CPU, against the JAX
package and against the port's own single-process estimator.

Every run starts its ranks as subprocesses of
`python -m raytracer_tpu_torch.parallel.worker` (parallel/worker.launch,
a file:// store under the test's temporary directory, a deadline of
TIMEOUT seconds); the ranks import torch and the port only. The JAX
references run in this process on the CPU. Where a shard_map compile of
the JAX package would cost tier 1 too much, the reference is the JAX
package's own per-shard estimator, as tests/test_sharding.py builds it:
`sharding._render_local` (or `_tile_loss_grad`) on rank i's chunk with
fold_in(key, i), which is what its shard_map runs.

Rules: images against JAX as tests/test_torch_render.py (>= 99% of pixels
within 1e-4 + 1e-3 |x|, mean |diff| < 1e-3 of the mean); against the
port's single-process per-shard estimator bit for bit. Loss and grads
against JAX as tests/test_torch_train.py (loss rtol 1e-5, each leaf
within rtol 1e-3 and atol 1e-4 x max|leaf|); against the port's
single-process sums with the JAX package's rule for a reduction in another
order (tests/test_sharding.py: loss rtol 1e-6, grads rtol 1e-5, atol
1e-8). Geometry-sharded against the port's data-parallel result of the
same run with tests/test_sharding.py:264-300's rule (images rtol 1e-4,
atol 1e-5; grads rtol 2e-4, atol 3e-5).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.parallel import sharding as js
from raytracer_tpu_torch import convert, graft_entry
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.diff import edges as ted
from raytracer_tpu_torch.parallel import distributed, sharding as ts, worker
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.render.renderer import render_pixels
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, jax_camera, jax_settings

TIMEOUT = 120
SEED = 7
SHIFT = (0.0, 0.05, 0.0)
# scene: (registry builder, its arguments, the JAX intersector, JAX
# builder arguments)
SCENES = dict(
    triangle_sphere=(registry.triangle_sphere, dict(size=8), 'brute', {}),
    sponza_12=(registry.sponza_standin, dict(width=16, height=12,
                                             max_bounces=2, n_spheres=12),
               'cluster_pallas', {}),
    instanced_teapots=(registry.instanced_teapots_standin,
                       dict(width=16, height=12), 'cluster2',
                       dict(bvh=True)))
# run: (scene, worker tasks, worker arguments)
RUNS = dict(
    triangle_sphere=('triangle_sphere',
                     ['render', 'step', 'loss', 'train', 'edges'],
                     ['--tile', 16]),
    triangle_sphere_pad=('triangle_sphere', ['step'], ['--tile', 22]),
    triangle_sphere_shift=('triangle_sphere',
                           ['render_geometry', 'step_geometry'],
                           ['--shift', ','.join(map(str, SHIFT))]),
    sponza_12=('sponza_12', ['render', 'render_geometry', 'loss',
                             'step_geometry', 'step_geometry@remat'],
               ['--shift', ','.join(map(str, SHIFT))]),
    instanced_teapots=('instanced_teapots', ['render'], []),
    triangle_sphere_3=('triangle_sphere', ['render', 'loss',
                                           'render_geometry',
                                           'step_geometry'], []))
_runs = {}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """run(name) -> the arrays of a worker run of RUNS[name] (3 ranks for
    a name ending in _3, else 2), once a module."""
    def get(name):
        if name not in _runs:
            scene, tasks, args = RUNS[name]
            make, kw, _, _ = SCENES[scene]
            res = worker.launch(
                3 if name.endswith('_3') else 2, ['--scene', make.__name__, '--scene-kw', json.dumps(kw),
                    '--tasks', ','.join(tasks), '--seed', SEED, *args],
                str(tmp_path_factory.mktemp(name) / 'out.npz'),
                device='cpu', timeout=TIMEOUT)
            res['stats'] = json.loads(str(res['stats']))
            _runs[name] = res
        return _runs[name]
    return get


def _port(scene):
    make, kw, _, _ = SCENES[scene]
    return cpu(make, **kw)


def _jax(scene):
    make, kw, jmode, jkw = SCENES[scene]
    sj, cam, st = cpu(make, **kw, builder=rj.SceneBuilder(), **jkw)
    return sj, jax_camera(cam), jax_settings(st, intersector=jmode), st


def _chunks(st, D=2):
    """Each rank's (px, py) numpy chunk of render_sharded."""
    px, py = (x.numpy() for x in cam_mod.pixel_coords(st.width, st.height))
    pad = (-px.shape[0]) % D
    px, py = (np.concatenate([x, np.zeros(pad, np.float32)])
              for x in (px, py))
    n = px.shape[0] // D
    return [(px[i * n:(i + 1) * n], py[i * n:(i + 1) * n]) for i in range(D)]


_jax_render_local = jax.jit(js._render_local,
                            static_argnames=('settings', 'spp'))


def _jax_per_shard_image(scene, D=2):
    sj, cam, stj, st = _jax(scene)
    key = jax.random.PRNGKey(SEED)
    outs = [_jax_render_local(sj, cam, stj, 1, jnp.asarray(px),
                              jnp.asarray(py), jax.random.fold_in(key, i))
            for i, (px, py) in enumerate(_chunks(st, D))]
    R = st.width * st.height
    return np.asarray(jnp.concatenate(outs))[:R].reshape(st.height,
                                                        st.width, 3)


def _jax_per_shard_loss(scene, D=2, shift=(0.0, 0.0, 0.0)):
    """The JAX package's loss_and_grads estimator on a zero target, rank
    by rank (sharding.py:178-193 under shard_map)."""
    sj, cam, stj, st = _jax(scene)
    params = js.get_params(sj)
    params['vertices'] = params['vertices'] + jnp.asarray(shift)
    key = jax.random.PRNGKey(SEED)
    R = st.width * st.height
    total, grads = 0.0, None
    for i, (px, py) in enumerate(_chunks(st, D)):
        msk = (np.arange(px.shape[0]) + i * px.shape[0] < R)
        l, g = js._tile_loss_grad(params, sj, cam, stj,
                                  jnp.zeros((px.shape[0], 3)),
                                  jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(msk, jnp.float32),
                                  jax.random.fold_in(key, i), 1)
        total = total + float(l)
        grads = g if grads is None else jax.tree_util.tree_map(jnp.add,
                                                               grads, g)
    scale = 1.0 / (R * 3)
    return total * scale, {k: np.asarray(v) * scale for k, v in grads.items()}


def _images_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    within = (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1)
    assert within.mean() >= 0.99, f'{within.mean():.4f} of pixels within'
    assert d.mean() < 1e-3 * np.abs(want).mean()
    assert want.mean() > 0


def _grads_close_to_jax(loss, grads, lj, gj):
    np.testing.assert_allclose(float(loss), lj, rtol=1e-5)
    for k in ts.PARAM_KEYS:
        got, want = grads[k], gj[k]
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)


def _grads(res, task):
    return {k: res[f'{task}/grad/{k}'] for k in ts.PARAM_KEYS}


def _port_meshless_step(scene, tile, params=None, target=None):
    sp, cam, st = _port(scene)
    params = ts.get_params(sp) if params is None else params
    target = torch.zeros((st.height, st.width, 3)) if target is None \
        else target
    loss, g = ts.loss_and_grads_scanned(params, sp, cam, st, target,
                                        rng.PRNGKey(SEED), tile=tile)
    return float(loss), {k: v.numpy() for k, v in g.items()}


def _reduced_order_close(loss, grads, l1, g1):
    np.testing.assert_allclose(float(loss), l1, rtol=1e-6)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(grads[k], g1[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


@pytest.mark.parametrize('name', ['triangle_sphere', 'sponza_12',
                                  'instanced_teapots'])
def test_render_sharded_matches_jax(run, name):
    """Two ranks' render_sharded against the JAX package's per-shard
    estimator, and bit for bit against the port's (rank i renders its
    chunk with fold_in(key, i) in one render_pixels call)."""
    img = run(name)['render/img']
    _images_close(img, _jax_per_shard_image(name))
    sp, cam, st = _port(name)
    own = torch.cat([render_pixels(sp, cam, st, 1, torch.from_numpy(px),
                                   torch.from_numpy(py),
                                   rng.fold_in(rng.PRNGKey(SEED), i))
                     for i, (px, py) in enumerate(_chunks(st))])
    own = own[:st.width * st.height].reshape(st.height, st.width, 3)
    np.testing.assert_array_equal(img, own.numpy())
    # each rank traced its own chunk, with the plain tracers
    assert all(s['render']['plain_calls'] > 0 and s['render']['gathers'] == 1
               for s in run(name)['stats'])


@pytest.mark.parametrize('name,tile', [('triangle_sphere', 16),
                                       ('triangle_sphere_pad', 22)])
def test_scanned_step_on_two_ranks(run, name, tile):
    """loss_and_grads_scanned(mesh) with 4 tiles, and with 3 padded to 4
    by a whole zero-mask tile: against the JAX package's single-device
    estimator (loss_and_grads_streamed, the scan's host loop) and the
    port's mesh-less step."""
    res = run(name)
    loss, grads = res['step/loss'], _grads(res, 'step')
    sj, cam, stj, st = _jax('triangle_sphere')
    lj, gj = js.loss_and_grads_streamed(
        js.get_params(sj), sj, cam, stj,
        jnp.zeros((st.height, st.width, 3)), jax.random.PRNGKey(SEED),
        spp=1, tile=tile)
    _grads_close_to_jax(loss, grads, float(lj),
                        {k: np.asarray(v) for k, v in gj.items()})
    _reduced_order_close(loss, grads, *_port_meshless_step(
        'triangle_sphere', tile))
    # two tiles a rank (the padding tile on rank 1), one reduction
    assert all(s['step']['plain_calls'] > 0 for s in res['stats'])
    assert all(s['step']['reduces'] == 1 for s in res['stats'])


def test_loss_and_grads_whole_image_matches_jax(run):
    res = run('triangle_sphere')
    lj, gj = _jax_per_shard_loss('triangle_sphere')
    _grads_close_to_jax(res['loss/loss'], _grads(res, 'loss'), lj, gj)


def test_train_step_on_two_ranks_matches_optax_adam(run):
    """Two train_step(mesh) steps: every rank applies optax's Adam step to
    the reduced gradients (parameters within 1e-6), the ranks end with
    the same parameters, and the first step's gradients are the
    mesh-less step's."""
    res = run('triangle_sphere')
    sp, _, _ = _port('triangle_sphere')
    start = convert.params_to_arrays(ts.get_params(sp))
    opt = optax.adam(0.01)
    p = {k: jnp.asarray(v) for k, v in start.items()}
    state = opt.init(p)
    for i in range(2):
        g = {k: jnp.asarray(res[f'train/grad{i}/{k}']) for k in ts.PARAM_KEYS}
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(res[f'train/param/{k}'], np.asarray(p[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert not np.array_equal(res['train/param/vertices'], start['vertices'])
    sums = [s['train']['param_sum'] for s in res['stats']]
    assert sums[0] == sums[1]
    _reduced_order_close(res['train/losses'][0],
                         {k: res[f'train/grad0/{k}'] for k in ts.PARAM_KEYS},
                         *_port_meshless_step('triangle_sphere', 16))


def test_edges_with_mesh_match_meshless(run):
    """loss_and_grads_with_edges(mesh=): the interior sums reduced over
    the ranks, the boundary terms computed whole on every rank with the
    same keys -> the mesh-less result."""
    res = run('triangle_sphere')
    sp, cam, st = _port('triangle_sphere')
    loss, g = ted.loss_and_grads_with_edges(
        ts.get_params(sp), sp, cam, st, torch.zeros((8, 8, 3)),
        rng.PRNGKey(SEED), tile=16, edge_samples=worker.EDGE_SAMPLES)
    _reduced_order_close(res['edges/loss'], _grads(res, 'edges'),
                         float(loss), {k: v.numpy() for k, v in g.items()})
    assert not np.allclose(res['edges/grad/vertices'],
                           res['step/grad/vertices'])


def test_geometry_sharded_matches_jax(run):
    """render_geometry_sharded and loss_and_grads_geometry_sharded with
    the vertices shifted by (0, 0.05, 0) (each rank refreshes its shard):
    against the JAX package's per-shard estimator, which
    render_geometry_sharded and loss_and_grads_geometry_sharded compute
    there too (same keys; only the exact tracer differs)."""
    res = run('triangle_sphere_shift')
    _images_close(res['render_geometry/img'],
                  _jax_per_shard_image('triangle_sphere'))
    lj, gj = _jax_per_shard_loss('triangle_sphere', shift=SHIFT)
    grads = _grads(res, 'step_geometry')
    _grads_close_to_jax(res['step_geometry/loss'], grads, lj, gj)
    assert np.abs(grads['vertices']).max() > 0
    for s in res['stats']:      # two ring rounds a trace
        assert s['step_geometry']['ring_rounds'] == \
            2 * s['step_geometry']['ring_traces'] > 0


def test_geometry_sharded_matches_data_parallel(run):
    """The atrium's geometry-sharded frame and step against the
    data-parallel ones of the same run."""
    res = run('sponza_12')
    np.testing.assert_allclose(res['render_geometry/img'],
                               res['render/img'], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res['step_geometry/loss'], res['loss/loss'],
                               rtol=1e-5)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(res[f'step_geometry/grad/{k}'],
                                   res[f'loss/grad/{k}'], rtol=2e-4,
                                   atol=3e-5, err_msg=k)
    assert np.abs(res['step_geometry/grad/vertices']).max() > 0
    # the ring's hops: two a trace (the last one carries the results)
    for s in res['stats']:
        g = s['render_geometry']
        assert g['hops'] == 2 * g['ring_traces'] > 0 and g['flags'] > 0


def test_geometry_sharded_remat_matches_plain(run):
    """The atrium's geometry-sharded step with RenderSettings.remat
    against the same step without it, in the same run: each rank replays
    every step in its backward pass, the ring's hops with it, and its
    forward pass counts as without remat."""
    res = run('sponza_12')
    np.testing.assert_allclose(res['step_geometry@remat/loss'],
                               res['step_geometry/loss'], rtol=1e-5)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(res[f'step_geometry@remat/grad/{k}'],
                                   res[f'step_geometry/grad/{k}'],
                                   rtol=2e-4, atol=3e-5, err_msg=k)
    for s in res['stats']:
        plain, remat = s['step_geometry'], s['step_geometry@remat']
        replay = remat['recompute']
        assert not plain['recompute'] and replay['steps'] > 0
        for k in ('hops', 'ring_traces', 'ring_rounds'):
            assert remat[k] == plain[k] == replay[k] > 0, k


def test_three_ranks_pad_the_pixels(run):
    """Three ranks over 64 pixels: two padding lanes on the last rank,
    masked out of the loss; against the JAX package's per-shard estimator
    over 3 chunks, and the geometry-sharded run against the data-parallel
    one."""
    res = run('triangle_sphere_3')
    _images_close(res['render/img'], _jax_per_shard_image('triangle_sphere',
                                                          D=3))
    _grads_close_to_jax(res['loss/loss'], _grads(res, 'loss'),
                        *_jax_per_shard_loss('triangle_sphere', D=3))
    np.testing.assert_allclose(res['render_geometry/img'], res['render/img'],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res['step_geometry/loss'], res['loss/loss'],
                               rtol=1e-5)
    for k in ts.PARAM_KEYS:
        np.testing.assert_allclose(res[f'step_geometry/grad/{k}'],
                                   res[f'loss/grad/{k}'], rtol=2e-4,
                                   atol=3e-5, err_msg=k)


def test_mesh_and_ring_need_a_process_group():
    sp, cam, st = _port('triangle_sphere')
    with pytest.raises(RuntimeError, match='init_from_env'):
        ts.make_mesh()
    with pytest.raises(TypeError, match='distributed.Mesh'):
        ts.render_sharded(sp, cam, st, rng.PRNGKey(0), mesh=2)
    assert distributed.process_info() == (0, 1)


def test_graft_entry_dryrun_and_entry():
    """dryrun_multichip(2) on gloo ranks on the CPU: two train steps and
    one whole-image loss, finite, the ranks agreeing; entry() renders."""
    res = graft_entry.dryrun_multichip(2, device='cpu', timeout=TIMEOUT)
    assert res['train/losses'][1] != res['train/losses'][0]
    fn, args = graft_entry.entry(device='cpu')
    img = fn(*args)
    assert img.shape == (48, 64, 3) and bool(img.isfinite().all())


def test_init_from_env_choices(monkeypatch):
    """The backend and device come from the RT_* variables alone: nothing
    without a store, gloo ranks on the CPU, no NCCL on the CPU, and no
    more NCCL ranks than cards."""
    for k in ('RT_COORDINATOR', 'RT_CPU_DEVICES', 'RT_BACKEND'):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_from_env() is False
    monkeypatch.setenv('RT_NUM_PROCESSES', '2')
    monkeypatch.setenv('RT_PROCESS_ID', '1')
    monkeypatch.setenv('RT_CPU_DEVICES', '1')
    assert distributed.backend_from_env() == 'gloo'
    assert distributed.device() == torch.device('cpu')
    monkeypatch.setenv('RT_BACKEND', 'nccl')
    with pytest.raises(ValueError, match='gloo'):
        distributed.backend_from_env()
    monkeypatch.delenv('RT_CPU_DEVICES')
    monkeypatch.setenv('RT_BACKEND', 'mpi')
    with pytest.raises(ValueError, match='nccl or gloo'):
        distributed.backend_from_env()
    monkeypatch.setenv('RT_BACKEND', 'nccl')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert distributed.device() == torch.device('cuda', 0)
    with pytest.raises(RuntimeError, match='one card a rank'):
        distributed.init_from_env('file:///nonexistent/store')
    monkeypatch.setenv('RT_BACKEND', 'gloo')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='RT_CPU_DEVICES'):
        distributed.init_from_env('file:///nonexistent/store')
