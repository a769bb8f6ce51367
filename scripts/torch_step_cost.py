"""A benchmark cell's run with its bounce loop cut after k steps, on the card.

    python3 scripts/torch_step_cost.py [--tree DIR] [--workload NAME]
                                       [--runs N]

Runs the cell of the checkout at DIR (default: this one) as
`python -m raytracer_tpu_torch.bench` runs it (its scene, settings and
keys; the kernels built and the stand-in tree written first), with
RenderSettings.max_wavefront_steps cut to 1, 2, ... up to the cell's own,
and prints one JSON line a cut: the median and every wall of N timed runs
after a warm-up (each ending in torch.cuda.synchronize()), the live rays
at the start of each step of the last run (the bounce loop's stop count,
integrator.LIVE_RAYS), and the peak memory. A wall less the one before it
is what step k costs end to end. Run it in turns on two trees in one chip
call to compare them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
ap.add_argument('--tree', default=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ap.add_argument('--workload', default='final_forest_frame_1080p')
ap.add_argument('--runs', type=int, default=5)
a = ap.parse_args()
sys.path.insert(0, os.path.abspath(a.tree))

import torch  # noqa: E402

from raytracer_tpu_torch import bench  # noqa: E402
from raytracer_tpu_torch.core import vecmath as vm  # noqa: E402
from raytracer_tpu_torch.render import integrator  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def live_rays(cell, scene, cam, st, key) -> list:
    """The rays alive at each bounce step's start in one run (counted
    only while vecmath.PROFILE_PARTS is on)."""
    integrator.reset_live()
    vm.PROFILE_PARTS = True
    try:
        bench.outputs(cell, scene, cam, st, key)
    finally:
        vm.PROFILE_PARTS = False
    alive = integrator.LIVE_RAYS['alive']
    return [] if alive is None else alive.tolist()


cell = bench.cells()[a.workload]
bench.build_kernels()
with bench.asset_tree():
    scene, cam, st = bench.build(cell)
    full = st.max_wavefront_steps
    for cut in range(1, full + 1):
        st_k = dataclasses.replace(st, max_wavefront_steps=cut)
        timed(lambda: bench.outputs(cell, scene, cam, st_k,
                                    bench.run_key(0, 0)))
        torch.cuda.reset_peak_memory_stats()
        walls = [timed(lambda i=i: bench.outputs(
            cell, scene, cam, st_k, bench.run_key(0, 1 + i)))
            for i in range(a.runs)]
        print(json.dumps(dict(
            tree=os.path.abspath(a.tree), workload=a.workload, steps=cut,
            of=full, median_s=statistics.median(walls), walls_s=walls,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            live_rays=live_rays(cell, scene, cam, st_k, bench.run_key(0, 1)),
            device=bench.card())), flush=True)
