"""Split a benchmark cell's set-up into its parts, on the card.

    python3 scripts/torch_setup_split.py [--tree DIR] [--workload NAME]

`setup_s` of `python -m raytracer_tpu_torch.bench` times, after the
kernels are built, writing the stand-in asset tree, building the cell's
scene and its first call. This runs the same steps for one cell of the
checkout at DIR (default: this one) and prints one JSON line with each
part's seconds, and the second call's beside the first: a first call
slower than the second by more than the run's noise is work that only a
first call does (a module loaded, a cache filled). Run it in turns on two
trees in one chip call to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
ap.add_argument('--tree', default=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ap.add_argument('--workload', default='final_forest_frame_1080p')
a = ap.parse_args()
sys.path.insert(0, os.path.abspath(a.tree))

import torch  # noqa: E402

from raytracer_tpu_torch import bench  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


cell = bench.cells()[a.workload]
build_s = bench.build_kernels()
t0 = time.perf_counter()
with bench.asset_tree():
    tree_s = time.perf_counter() - t0
    (scene, cam, st), scene_s = timed(lambda: bench.build(cell))
    _, first_s = timed(lambda: bench.outputs(cell, scene, cam, st,
                                             bench.run_key(0, 1000)))
    setup_s = time.perf_counter() - t0
    _, second_s = timed(lambda: bench.outputs(cell, scene, cam, st,
                                              bench.run_key(0, 1001)))
print(json.dumps(dict(tree=os.path.abspath(a.tree), workload=a.workload,
                      kernel_build_s=build_s, setup_s=setup_s,
                      tree_s=tree_s, scene_s=scene_s, first_call_s=first_s,
                      second_call_s=second_s, device=bench.card())),
      flush=True)
