"""Trace chip_smoke.py's phase 5 (the 1080p `sponza_standin` frame) of a
checkout on one GPU, to tell where a difference in its wall comes from:

    python3 scripts/torch_render_trace.py [TREE]

Runs TREE's (default: this checkout's) package and chip_smoke.py phases 1-5
as that script runs them: the four kernels and the host library built
together, the scene, the cluster kernel against its plain version at
32,768 rays and at the frame's 2,073,600 (phase 4), the frame through
chip_smoke.render_cell (phase 5). Around them it measures the frame, one
JSON line each:

  * `before_phase_4`, `after_phase_5`, `after_empty_cache`: the median wall
    of 3 renders after a warm-up, right after the scene is built, after
    phase 5, and after torch.cuda.empty_cache() (the caching allocator's
    state after phase 4's large plain traces);
  * `profile`: one render under torch.profiler: its wall, the device
    kernels' time, count and busy share, the cluster kernel's device ms,
    the host time of the kernel launches and the top host operations by
    self CPU time;
  * the card's SM clock, power draw and temperature with each line.

To compare a parent and a change, run both in one call, in turns (parent,
change, change, parent), each with this checkout's script.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
sys.path.insert(0, tree)
os.chdir(tree)

import chip_smoke as cs  # noqa: E402
import raytracer_tpu_torch as rt  # noqa: E402
from raytracer_tpu_torch import native  # noqa: E402
from raytracer_tpu_torch.core import rng  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402


def card() -> dict:
    q = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,power.draw,'
                        'temperature.gpu', '--format=csv,noheader'],
                       capture_output=True, text=True).stdout.strip()
    return {'sm_clock_power_temp': q}


def walls(scene, cam, st, key, tag) -> None:
    rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    ws = []
    for _ in range(3):
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        ws.append(time.perf_counter() - t0)
    print(json.dumps({'tree': tree, 'at': tag, 'wall_s': ws,
                      'median_s': statistics.median(ws), **card()}),
          flush=True)


def profile(scene, cam, st, key) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in dev_ev)
    cluster_us = sum(e.device_time_total for e in dev_ev
                     if 'cluster_trace_kernel' in e.name)
    host = sorted(((a.key, a.self_cpu_time_total, a.count)
                   for a in prof.key_averages()),
                  key=lambda x: -x[1])
    launch_us = sum(us for k, us, _ in host if k == 'cudaLaunchKernel')
    print(json.dumps({
        'tree': tree, 'at': 'profile', 'profiled_wall_s': wall,
        'device_kernel_s': dev_us / 1e6, 'n_device_kernels': len(dev_ev),
        'device_busy_share': dev_us / 1e6 / wall,
        'cluster_kernel_ms': cluster_us / 1e3,
        'cuda_launch_kernel_host_ms': launch_us / 1e3,
        'top_host_self_ms': [(k, us / 1e3, n) for k, us, n in host[:12]],
        **card()}), flush=True)


def main() -> int:
    assert torch.cuda.is_available(), 'needs a CUDA device'
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(5) as pool:
        for job in [pool.submit(fn) for fn in (
                cs.ck.build, cs.isk.build, cs.ick.build, cs.mtk.build,
                native.get_lib)]:
            job.result()
    scene, cam, st = registry.sponza_standin(
        cs.WIDTH, cs.HEIGHT, max_bounces=cs.BOUNCES, ray_tile=cs.RAY_TILE,
        device=dev)
    torch.cuda.synchronize()
    key = rng.PRNGKey(cs.KEY)
    walls(scene, cam, st, key, 'before_phase_4')
    cs.compare_kernel(scene, cam, dev)
    cs.compare_full_wavefront(scene, cam, dev)
    cs.render_cell(scene, cam, st, key, cs.ck, 'render_1080p')
    walls(scene, cam, st, key, 'after_phase_5')
    profile(scene, cam, st, key)
    torch.cuda.empty_cache()
    walls(scene, cam, st, key, 'after_empty_cache')
    return 0


if __name__ == '__main__':
    sys.exit(main())
