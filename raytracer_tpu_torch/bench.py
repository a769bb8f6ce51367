"""The port's headline benchmark: primary rays/s of one training step.

    python -m raytracer_tpu_torch.bench [--width 1920] [--height 1080]
                                        [--bounces 10] [--spp 1]
                                        [--tile PIXELS] [--iters 5]

bench.py's configuration on the port: `sponza_standin` (the asset-free
stand-in of bench.py's `sponza_proxy(hd=True)`, 174,724 triangles) at
1920x1080, 1 spp, 10 path-traced bounces, forward render and backward pass
to all six parameter leaves against a zero target, through
parallel/sharding.loss_and_grads_scanned on one CUDA device. The kernel
builds and one warm-up step stay out of the timed runs; each timed run
takes its own key and ends in torch.cuda.synchronize(). Prints ONE JSON
line with bench.py's keys (metric, value, unit, vs_baseline, wall median
and spread, iters) under the metric name
`primary_rays_per_sec_fwd_bwd_sponza_standin_1080p`, plus the peak device
memory, the tile (`ray_tile`, in pixels of `spp` rays each) and the
card's `nvidia-smi` name and power limit.
vs_baseline divides by bench.py's estimate of the reference's CPU rate
(15,000 primary rays/s, forward only). Raises without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from .core import rng
from .ops.cuda import cluster_kernel
from .parallel import sharding
from .scenes import registry

METRIC = 'primary_rays_per_sec_fwd_bwd_sponza_standin_1080p'
REF_RAYS_PER_SEC = 15_000.0     # bench.py's estimate of the reference
# rays per tile of the training step: one tile holds the whole 1080p frame
# at 1 spp (the largest power of two that fits the 80 GB card with room to
# spare; PERF.md section 5 lists the peak at each size tried). A tile
# counts pixels, each of `spp` rays, so the default tile is
# TRAIN_TILE // spp pixels
TRAIN_TILE = 1 << 21


def card() -> str:
    """The card's `nvidia-smi` name and power limit."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(width: int = 1920, height: int = 1080, bounces: int = 10,
        spp: int = 1, tile: int | None = None, iters: int = 5,
        built=None) -> dict:
    """Build the scene (or take `built`, its (scene, camera, settings) on
    the card), warm up, time `iters` steps of `tile` pixels a tile
    (TRAIN_TILE // spp by default) -> the result line as a dict, with the
    last step's loss and grads under '_loss' and '_grads'."""
    if not torch.cuda.is_available():
        raise RuntimeError('the benchmark needs a CUDA device')
    tile = tile or TRAIN_TILE // spp
    cluster_kernel.build()
    scene, cam, st = built or registry.sponza_standin(
        width, height, max_bounces=bounces, ray_tile=tile)
    params = sharding.get_params(scene)
    target = torch.zeros((height, width, 3), device=scene.geom.vertices.device)
    key = rng.PRNGKey(0)

    def step(k):
        return sharding.loss_and_grads_scanned(params, scene, cam, st, target,
                                               k, spp=spp, tile=tile)

    t0 = time.perf_counter()
    step(key)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(iters):
        t0 = time.perf_counter()
        loss, grads = step(rng.fold_in(key, 1000 + i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    rate = width * height * spp / med
    return {
        'metric': METRIC, 'value': rate, 'unit': 'rays/s',
        'vs_baseline': rate / REF_RAYS_PER_SEC, 'wall_median_s': med,
        'wall_spread_s': [min(walls), max(walls)], 'iters': iters,
        'warmup_s': warm_s,
        'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
        'ray_tile': tile, 'spp': spp, 'bounces': bounces,
        'triangles': scene.num_tris, 'device': card(), '_loss': loss,
        '_grads': grads}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--width', type=int, default=1920)
    ap.add_argument('--height', type=int, default=1080)
    ap.add_argument('--bounces', type=int, default=10)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--tile', type=int, default=None,
                    help='pixels a tile (default TRAIN_TILE // spp)')
    ap.add_argument('--iters', type=int, default=5)
    a = ap.parse_args(argv)
    res = run(a.width, a.height, a.bounces, a.spp, a.tile, a.iters)
    loss = float(res.pop('_loss'))
    res.pop('_grads')
    print(json.dumps(res), flush=True)
    print(f'# loss={loss:.6f}', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
