"""The segment kernel's two routes of the prototype pool into shared memory,
timed against each other on one GPU: `python3 scripts/torch_iseg_routes.py`.

csrc/iseg_trace.cu reads a pool row either from a copy of the whole pool
that each block makes once (resident: the pool's real rows fit in
ops/cuda/iseg_kernel.RESIDENT_BYTES) or from two per-warp buffers that it
fills row by row as the walk visits them (staged). This script runs the
same cases through both, in turns resident, staged, staged, resident (the
resident route taken by every pool up to RESIDENT_TRIED, the staged one
forced by RESIDENT_BYTES = 0), with the outputs of every turn held bit for
bit (t, tri, inst, a, b) to the first:

  * the 100,000-instance grid at 32,768 rays (chip_smoke.py phase 7:
    coherent and incoherent, nearest and any-hit), each case the median
    CUDA-event time of 5 wrapper calls after a warm-up;
  * the grid's 518,400-ray band of 1080p camera rays (nearest) and one
    sorted bounce from their hits (any-hit), median of 3;
  * `final_forest_standin(n_trees=0)` at 32,768 rays in its `need_ab`
    modes, at the ray bounds of chip_smoke.py phase 10;
  * both scenes' 1080p frames: the median wall of 3 renders and the
    segment kernel's device time in one profiled render.

Prints one JSON line per case and turn, then a summary line per case with
each route's times. Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import raytracer_tpu_torch as rt  # noqa: E402
from raytracer_tpu_torch.core import rng  # noqa: E402
from raytracer_tpu_torch.ops import bundle  # noqa: E402
from raytracer_tpu_torch.ops.cuda import iseg_kernel as isk  # noqa: E402
from raytracer_tpu_torch.render import camera as cam_mod  # noqa: E402
from raytracer_tpu_torch.render import integrator  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402

# the largest pool put on the resident route here: both scenes' pools
# (the grid's 40 KB, the tree-less final forest's 70 KB) fit
RESIDENT_TRIED = 72 * 1024


def set_route(route: str) -> None:
    """Take the resident route where the pool fits in RESIDENT_TRIED, or
    the staged one always; the cached walk tables hold the route, so they
    are dropped."""
    isk.RESIDENT_BYTES = RESIDENT_TRIED if route == 'resident' else 0
    bundle._levels.pop('segments', None)


def grid_cases(scene, cam, dev):
    """The grid's cases: name -> (o, d, time, tmin, tmax, any_hit, reps)."""
    cases = {}
    rs = np.random.default_rng(cs.KEY + 1)
    for kind, (o, d) in cs.instanced_rays(scene, cam, dev).items():
        far = torch.full((cs.N_RAYS,), 1e12, device=dev)
        near = isk.iseg_trace(scene, o, d, 0.0, 1e-3, far).t
        u = torch.as_tensor(rs.uniform(0.5, 1.5, cs.N_RAYS),
                            dtype=torch.float32, device=dev)
        cases[f'grid_{kind}_nearest'] = (o, d, 0.0, 1e-3, far, False, 5)
        cases[f'grid_{kind}_any'] = (o, d, 0.0, 1e-3,
                                     torch.clamp(near * u, max=1e12), True, 5)
    o, d, _ = cam_mod.center_rays(cam, cs.WIDTH, cs.HEIGHT)
    band = slice(cs.WIDTH * (cs.HEIGHT - 270) // 2,
                 cs.WIDTH * (cs.HEIGHT + 270) // 2)
    o, d = o[band].to(dev), d[band].to(dev)
    R = o.shape[0]
    far = torch.full((R,), 1e12, device=dev)
    first = isk.iseg_trace(scene, o, d, 0.0, 1e-3, far)
    alive = first.tri >= 0
    rs = np.random.default_rng(cs.KEY + 7)
    d2 = rs.normal(size=(R, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    bounce = integrator._sort_wavefront({
        'o': torch.where(alive[:, None], o + first.t[:, None] * d, o),
        'd': f(d2), 'alive': alive,
        'tmax': torch.where(alive, f(rs.uniform(0.5, 12.0, R)), -1.0)})
    cases['band_nearest'] = (o, d, 0.0, 1e-3, far, False, 3)
    cases['band_bounce_any'] = (bounce['o'], bounce['d'], 0.0, 1e-3,
                                bounce['tmax'], True, 3)
    return cases


def forest_cases(scene, cam, dev):
    """The tree-less final forest's need_ab cases, at phase 10's bounds."""
    cases = {}
    shutter = float(cam.shutter)
    rs = np.random.default_rng(cs.KEY + 3)
    rs4 = np.random.default_rng(cs.KEY + 4)
    for kind, (o, d) in cs.instanced_rays(scene, cam, dev).items():
        times = torch.as_tensor(1.0 - shutter * rs.uniform(size=cs.N_RAYS),
                                dtype=torch.float32, device=dev)
        first = isk.iseg_trace(scene, o, d, times, 1e-3, 1e12)
        tmin, tmax_near, tmax_any = cs.march_inputs(first.t, first.tri >= 0,
                                                    rs4)
        cases[f'forest0_{kind}_nearest'] = (o, d, times, tmin, tmax_near,
                                            False, 5)
        cases[f'forest0_{kind}_exact_any'] = (o, d, times, tmin, tmax_any,
                                              True, 5)
    return cases


def frame(scene, cam, st, key):
    """-> (median wall s of 3 renders after a warm-up, the segment
    kernel's device ms in one profiled render)."""
    rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and 'iseg_trace_kernel' in e.name)
    return statistics.median(walls), us / 1e3


def main() -> int:
    assert torch.cuda.is_available(), 'needs a CUDA device'
    dev = torch.device('cuda', 0)
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit '
                   '--format=csv,noheader').read().strip()
    print(smi, flush=True)
    isk.build()
    key = rng.PRNGKey(cs.KEY)
    scenes = {
        'grid': registry.instanced_grid_standin(
            cs.WIDTH, cs.HEIGHT, ray_tile=cs.RAY_TILE, device=dev),
        'forest0': registry.final_forest_standin(
            cs.WIDTH, cs.HEIGHT, n_trees=0, ray_tile=cs.RAY_TILE, device=dev)}
    set_route('resident')
    for name, (scene, _, _) in scenes.items():
        lanes = isk.row_lanes(scene.iclusters.tri)
        _, n_slots = isk.pool_slots(lanes, scene.iclusters.tri.shape[1])
        print(json.dumps({'scene': name, 'pool_rows': int(lanes.numel()),
                          'real_rows': int((lanes > 0).sum()),
                          'resident_rows': n_slots}), flush=True)
    cases = {'grid': grid_cases(*scenes['grid'][:2], dev),
             'forest0': forest_cases(*scenes['forest0'][:2], dev)}
    ref: dict = {}
    times: dict = {}
    for turn, route in enumerate(('resident', 'staged', 'staged',
                                  'resident'), 1):
        for name, (scene, cam, st) in scenes.items():
            set_route(route)
            for case, (o, d, tm, tmin, tmax, any_hit, reps) in \
                    cases[name].items():
                ms, h = cs.cuda_ms(lambda: isk.iseg_trace(
                    scene, o, d, tm, tmin, tmax, any_hit), reps=reps)
                out = [x for x in (h.t, h.tri, h.inst, h.a, h.b)
                       if x is not None]
                if case not in ref:
                    ref[case] = out
                same = all(torch.equal(x, y) for x, y in zip(out, ref[case]))
                print(json.dumps({'turn': turn, 'route': route, 'case': case,
                                  'n': o.shape[0], 'ms': ms,
                                  'same_as_turn_1': same}), flush=True)
                assert same, f'{case}: the {route} route disagrees'
                times.setdefault(case, {}).setdefault(route, []).append(ms)
            wall, kernel_ms = frame(scene, cam, st, key)
            print(json.dumps({'turn': turn, 'route': route,
                              'case': f'{name}_frame_1080p',
                              'median_wall_s': wall,
                              'kernel_device_ms': kernel_ms}), flush=True)
            times.setdefault(f'{name}_frame_wall_s', {}).setdefault(
                route, []).append(wall)
            times.setdefault(f'{name}_frame_kernel_ms', {}).setdefault(
                route, []).append(kernel_ms)
    for case, by_route in times.items():
        print(json.dumps({'summary': case, **by_route}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
