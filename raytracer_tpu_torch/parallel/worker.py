"""One rank of a several-rank run: `python -m
raytracer_tpu_torch.parallel.worker --scene NAME [options]`.

Port of scripts/multihost_worker.py. Each rank joins the process group
(distributed.init_from_env: RT_NUM_PROCESSES, RT_PROCESS_ID, and
RT_COORDINATOR or --init; RT_CPU_DEVICES=1 for gloo ranks on the CPU,
RT_BACKEND=gloo for several ranks on one card), builds the registry scene
NAME on its device (--scene-kw: the builder's keyword arguments as JSON),
and runs --tasks in order over the mesh of every rank:

  render          sharding.render_sharded -> img
  render_geometry sharding.render_geometry_sharded -> img
  loss            sharding.loss_and_grads(mesh) -> loss, grad/<leaf>
  step            sharding.loss_and_grads_scanned(mesh=, tile=)
  step_geometry   sharding.loss_and_grads_geometry_sharded
  edges           diff/edges.loss_and_grads_with_edges(mesh=), with
                  EDGE_SAMPLES
  train           TRAIN_STEPS of sharding.train_step(mesh=) (Adam, lr
                  LR) -> losses, grad<i>/<leaf> of step i, param/<leaf>
                  after
  ring            the rays in --rays (.npz of o, d, time, tmin, tmax, and
                  any_tmax for the any-hit pass, tmax if absent; the
                  ranks split them) through intersector 'ring'
                  (ops/ring_trace.RingTracer: ring_trace over the table's
                  shards, alpha tested inside its sweep in a scene with
                  alpha maps), nearest (t, tri, a, b) and any-hit (any_t,
                  any_tri)

A task named `<task>@nosort` runs with the wavefront sort off, and
`<task>@remat` with RenderSettings.remat on (the stats' `recompute`:
what the backward pass's replays counted); --repeat runs each task
that many times (the first run of a task in a process pays its
warm-up), its stats the last run's with every run's wall. The
parameters are the scene's, with --shift added to the vertices; the target
is black (bench.py's), with --spp samples a pixel (1) in the render and
step tasks. Every loss, gradient and image must be finite. Rank 0 writes
RT_OUT (.npz): `<task>/<name>` arrays, and `stats`, the JSON list of each
rank's per-task wall, peak memory, kernel launches by mode, plain-version
calls, ring rounds and collective counters, with the frame's pixels and
the rank's device (`card`: the card's UUID, or 'cpu'). CPU ranks share
the host's cores evenly.

`launch` starts the ranks as subprocesses, each with a deadline.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..core import rng
from ..diff import edges
from ..ops import cluster_trace as ct, ring_trace as ring
from ..scenes import registry
from ..utils import counters
from . import distributed, sharding

# the train task's Adam steps and rate (the JAX dry run's two steps), and
# the edge task's samples
TRAIN_STEPS = 2
LR = 1e-2
EDGE_SAMPLES = 256
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch(n: int, args: list, out: str, device: str = 'cuda',
           backend: str = 'nccl', timeout: float = 120.0) -> dict:
    """Run n ranks of this worker with `args` on a file:// store beside
    `out`: on the card(s) under `backend` (NCCL, one rank a card; gloo,
    several ranks on one card), or gloo ranks on the CPU for device
    'cpu'. A rank that fails, or a run that outlives `timeout`
    seconds, stops every rank and raises with the ranks' logs -> the
    arrays rank 0 wrote to `out`, and 'logs' (each rank's output)."""
    store = out + '.store'
    for f in (out, store):
        if os.path.exists(f):
            os.remove(f)
    env = {k: v for k, v in os.environ.items()
           if k not in ('RT_COORDINATOR', 'RT_CPU_DEVICES', 'RT_BACKEND')}
    env.update(RT_NUM_PROCESSES=str(n), RT_OUT=out)
    if device == 'cpu':
        env['RT_CPU_DEVICES'] = '1'
    else:
        env['RT_BACKEND'] = backend
    logs = [out + f'.rank{i}.log' for i in range(n)]
    procs = []
    try:
        for i in range(n):
            with open(logs[i], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, '-u', '-m',
                     'raytracer_tpu_torch.parallel.worker',
                     '--init', f'file://{store}', *map(str, args)],
                    cwd=PKG_ROOT, env=dict(env, RT_PROCESS_ID=str(i)),
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll()]
            if bad:
                failed = f'rank {bad[0]} exited with {procs[bad[0]].poll()}'
            elif time.monotonic() > deadline:
                failed = f'the ranks outlived their {timeout:.0f} s'
            time.sleep(0.05)
        if failed is None and any(p.returncode for p in procs):
            failed = 'rank exit codes ' + str([p.returncode for p in procs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for f in logs:
        with open(f) as fh:
            text.append(fh.read())
    if failed is not None:
        raise RuntimeError(failed + '\n' + '\n'.join(
            f'--- rank {i}\n{t[-4000:]}' for i, t in enumerate(text)))
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    res['logs'] = text
    return res


def _counts() -> dict:
    """Every trace kernel's launches by mode, the plain versions' calls, the
    alpha march's passes, the near-ordered sweeps (ops/cluster_trace.
    local_sweep: intersector 'cluster', the ring's rounds in a scene with
    alpha maps), the ring's traces, rounds and collectives since the
    last reset, and under remat what the backward pass's replays counted
    (utils/counters.RECOMPUTE)."""
    kernels = counters.KERNELS.items()
    return dict(
        launches={k: m.LAUNCHES for k, m in kernels},
        modes={k: dict(m.MODES) for k, m in kernels if m.LAUNCHES},
        plain_calls=sum(m.CALLS for m in counters.PLAINS),
        ring_traces=ring.TRACES, ring_rounds=ring.ROUNDS,
        march_passes=ct.MARCH_PASSES, sweeps=ct.SWEEPS,
        recompute=dict(counters.RECOMPUTE), **distributed.STATS)


def card_of(dev: torch.device) -> str:
    """Which card a rank runs on: its UUID (the PCI address where torch
    gives none), or 'cpu'."""
    if dev.type != 'cuda':
        return 'cpu'
    p = torch.cuda.get_device_properties(dev)
    return str(getattr(p, 'uuid', '') or '') or \
        f'{p.pci_domain_id}:{p.pci_bus_id}:{p.pci_device_id}'


def _finite(name: str, x) -> np.ndarray:
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)
    if not np.isfinite(x).all():
        raise RuntimeError(f'{name}: not finite')
    return x


def _loss_out(out: dict, task: str, loss, grads) -> None:
    out[f'{task}/loss'] = _finite(f'{task} loss', loss)
    for k, g in grads.items():
        out[f'{task}/grad/{k}'] = _finite(f'{task} grad {k}', g)


def _ring(a, scene, mesh, out: dict, task: str) -> None:
    dev = scene.geom.vertices.device
    with np.load(a.rays) as z:
        rays = {k: torch.from_numpy(z[k]).to(dev) for k in
                ('o', 'd', 'time', 'tmin', 'tmax', 'any_tmax') if k in z}
    rays.setdefault('any_tmax', rays['tmax'])
    R = rays['o'].shape[0]
    mine = {k: sharding._chunk(v, mesh.size, mesh.rank)
            for k, v in rays.items()}
    tracer = ring.RingTracer(dataclasses.replace(
        scene, clusters=ring.local_shard(scene.clusters, mesh)))
    for any_hit, pre in ((False, ''), (True, 'any_')):
        h = tracer(mine['o'], mine['d'], mine['time'], mine['tmin'],
                   mine[pre + 'tmax'], any_hit)
        for f in ('t', 'tri') + (() if any_hit else ('a', 'b')):
            full = distributed.all_gather_rows(getattr(h, f), mesh)
            out[f'{task}/{pre}{f}'] = full[:R].cpu().numpy()


def run_task(a, task: str, scene, cam, st, mesh, out: dict) -> dict:
    """One task of the module docstring, its outputs into `out` -> what
    the task adds to its rank's stats."""
    name, _, flag = task.partition('@')
    if flag not in ('', 'nosort', 'remat'):
        raise ValueError(f'task {task!r}: the flags are @nosort and @remat')
    if flag == 'nosort':
        st = dataclasses.replace(st, sort_rays=False)
    elif flag == 'remat':
        st = dataclasses.replace(st, remat=True)
    dev = scene.geom.vertices.device
    key = rng.PRNGKey(a.seed)
    params = sharding.get_params(scene)
    params['vertices'] = params['vertices'] + torch.tensor(a.shift,
                                                           device=dev)
    target = torch.zeros((st.height, st.width, 3), device=dev)
    if name in ('render', 'render_geometry'):
        fn = sharding.render_sharded if name == 'render' else \
            sharding.render_geometry_sharded
        img = fn(scene, cam, st, key, mesh, spp=a.spp)
        out[f'{task}/img'] = _finite(f'{task} image', img)
    elif name == 'loss':
        _loss_out(out, task, *sharding.loss_and_grads(
            params, scene, cam, st, target, key, mesh))
    elif name == 'step':
        _loss_out(out, task, *sharding.loss_and_grads_scanned(
            params, scene, cam, st, target, key, spp=a.spp, tile=a.tile,
            mesh=mesh))
    elif name == 'step_geometry':
        _loss_out(out, task, *sharding.loss_and_grads_geometry_sharded(
            params, scene, cam, st, target, key, mesh, spp=a.spp))
    elif name == 'edges':
        _loss_out(out, task, *edges.loss_and_grads_with_edges(
            params, scene, cam, st, target, key, tile=a.tile,
            edge_samples=EDGE_SAMPLES, mesh=mesh))
    elif name == 'train':
        opt = sharding.make_optimizer(params, lr=LR)
        losses, walls = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, loss = sharding.train_step(params, opt, scene, cam, st,
                                               target, key, tile=a.tile,
                                               mesh=mesh)
            walls.append(time.perf_counter() - t0)
            losses.append(float(_finite(f'{task} loss', loss)))
            for k, p in params.items():
                out[f'{task}/grad{i}/{k}'] = _finite(f'{task} grad', p.grad)
        out[f'{task}/losses'] = np.asarray(losses)
        for k, p in params.items():
            out[f'{task}/param/{k}'] = _finite(f'{task} param {k}', p)
        # every rank must hold the same parameters
        return dict(param_sum=[float(params[k].double().sum())
                               for k in sharding.PARAM_KEYS],
                    step_walls=walls)
    elif name == 'ring':
        _ring(a, scene, mesh, out, task)
    else:
        raise ValueError(f'unknown task {task!r}')
    return {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--scene', required=True)
    p.add_argument('--scene-kw', default='{}', type=json.loads)
    p.add_argument('--tasks', default='render,step')
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--tile', type=int, default=None)
    p.add_argument('--spp', type=int, default=1)
    p.add_argument('--shift', type=lambda s: [float(x) for x in s.split(',')],
                   default=[0.0, 0.0, 0.0])
    p.add_argument('--rays', default=None)
    p.add_argument('--repeat', type=int, default=1,
                   help='runs of each task; its stats are the last run\'s, '
                        'with every run\'s wall')
    p.add_argument('--init', default=None,
                   help='the store URL (file:// or tcp://); default '
                        'tcp://$RT_COORDINATOR')
    a = p.parse_args(argv)
    if not distributed.init_from_env(a.init):
        raise SystemExit('set RT_COORDINATOR, or pass --init')
    rank, world = distributed.process_info()
    dev = distributed.device()
    if dev.type == 'cpu':       # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t0 = time.perf_counter()
    scene, cam, st = registry.get(a.scene)(**a.scene_kw, device=dev)
    mesh = sharding.make_mesh()
    print(f'rank {rank}/{world} on {dev} ({mesh.backend}): {a.scene} built '
          f'in {time.perf_counter() - t0:.3f} s', flush=True)
    out, stats = {}, {}
    for task in a.tasks.split(','):
        walls = []
        for _ in range(a.repeat):
            counters.reset()
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            extra = run_task(a, task, scene, cam, st, mesh, out)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        stats[task] = dict(wall_s=walls[-1], walls=walls, **_counts(),
                           pixels=st.width * st.height, card=card_of(dev),
                           **extra)
        if dev.type == 'cuda':
            stats[task]['peak_mem_gb'] = \
                torch.cuda.max_memory_allocated(dev) / 1e9
        print(f'rank {rank}: {task} {json.dumps(stats[task])}', flush=True)
    every = [None] * world
    torch.distributed.all_gather_object(every, stats)
    if rank == 0:
        out['stats'] = np.asarray(json.dumps(every))
        with open(os.environ['RT_OUT'], 'wb') as f:
            np.savez(f, **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
