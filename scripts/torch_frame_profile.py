"""Where a 1080p frame of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch_frame_profile.py [--scene NAME] [--tiles 17,19,21]
                                           [--trace PATH]

Renders --scene (default `sponza_standin`: 1 spp, 10 bounces; or
`instanced_grid_standin`, `forest_standin` or `final_forest_standin` at
their own settings) at 1920x1080 with raytracer_tpu_torch on CUDA. For each ray tile size 2**k in
--tiles it prints the median wall time of 3 renders after a warm-up. Then
it profiles one render at the default tile with torch.profiler and prints
the device time by kernel name, the trace kernels' share, the device
busy share (device kernel time over wall time) and, for alpha scenes, the
alpha march's passes and host syncs. --trace writes the Chrome
trace. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu_torch as rt  # noqa: E402
from raytracer_tpu_torch.core import rng  # noqa: E402
from raytracer_tpu_torch.ops import cluster_trace as ct  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402

DEFAULT_TILE = 1 << 21      # chip_smoke.py's tile: the whole 1080p frame


def wall(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--scene', default='sponza_standin',
                    choices=('sponza_standin', 'instanced_grid_standin',
                             'forest_standin', 'final_forest_standin'))
    ap.add_argument('--tiles', default='17,19,21')
    ap.add_argument('--trace', default=None)
    args = ap.parse_args()
    assert torch.cuda.is_available(), 'needs a CUDA device'
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device('cuda', 0)
    scene_h, cam_h, st = registry.make(args.scene, width=1920, height=1080,
                                       ray_tile=DEFAULT_TILE)
    scene, cam = scene_h.to(dev), cam_h.to(dev)
    key = rng.PRNGKey(2024)
    W, H = st.width, st.height

    for k in (int(x) for x in args.tiles.split(',') if x):
        st_k = replace(st, ray_tile=1 << k)
        med, times = wall(lambda: rt.render(scene, cam, st_k, key))
        print(json.dumps({'ray_tile': 1 << k, 'median_s': med,
                          'wall_s': times, 'primary_rays_per_s': W * H / med,
                          'peak_mem_gb':
                              torch.cuda.max_memory_allocated() / 1e9}))
        torch.cuda.reset_peak_memory_stats()

    rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ct.MARCH_PASSES = ct.MARCH_SYNCS = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    trace_us = sum(v for n, v in by_name.items() if '_trace_kernel' in n)
    print(json.dumps({'scene': args.scene, 'profiled_wall_s': wall_s,
                      'device_kernel_s': total_us / 1e6,
                      'device_busy_share': total_us / 1e6 / wall_s,
                      'trace_kernel_s': trace_us / 1e6,
                      'trace_kernel_share_of_device':
                          trace_us / max(total_us, 1e-9),
                      'n_device_kernels': len(events),
                      'alpha_march_passes': ct.MARCH_PASSES,
                      'alpha_march_syncs': ct.MARCH_SYNCS}))
    for name, us in top:
        print(json.dumps({'kernel': name[:90], 'device_ms': us / 1e3,
                          'share': us / max(total_us, 1e-9)}))
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or '.', exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
