"""Where the sorted 'auto' and 'bvh' frames of the 1080p atrium part, on one
GPU.

    python3 scripts/torch_sort_divergence.py [--tiles 0,21]

Builds `sponza_standin` with its BVH (1920x1080, 1 spp, 10 bounces) on the
card and, for each ray tile in --tiles (0: the registry's tile for the
card, the frame rounded up to 1,024 rays; k: 2**k rays, the rest of the
tile padded with pixel 0's rays), renders the frame with intersectors
'auto' (the cluster kernel) and 'bvh' (the BVH kernel) through
chip_smoke.sorted_divergence. One JSON line a tile: every trace of the
'auto' frame run through both kernels (t differing, ties, barycentrics,
any-hit), each bounce's sorted wavefront compared slot by slot, the
sorted frames held to each other under chip_smoke.py phase 6's rule, and
for each camera ray whose nearest t differs both triangles' t, u and v in
float64 (Moller-Trumbore on the stored float32 vertices), so the exact
answer shows which tracer kept the nearer hit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from raytracer_tpu_torch.core import rng  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402


def exact_hit(vertices, face_v, tri, o, d):
    """(t, u, v) of ray (o, d) against triangle `tri`, in float64."""
    p0, p1, p2 = (vertices[i].astype(np.float64) for i in face_v[tri])
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    e1, e2 = p1 - p0, p2 - p0
    pv = np.cross(d, e2)
    inv = 1.0 / np.dot(e1, pv)
    tv = o - p0
    u = np.dot(tv, pv) * inv
    qv = np.cross(tv, e1)
    return float(np.dot(e2, qv) * inv), float(u), float(np.dot(d, qv) * inv)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--tiles', default='0,21')
    args = p.parse_args()
    assert torch.cuda.is_available(), 'needs a CUDA device'
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device('cuda', 0)
    scene, cam, st = registry.sponza_standin(
        chip_smoke.WIDTH, chip_smoke.HEIGHT, max_bounces=chip_smoke.BOUNCES,
        bvh=True, device=dev)
    vertices = scene.geom.vertices.cpu().numpy()
    face_v = scene.geom.face_v.cpu().numpy()
    key = rng.PRNGKey(chip_smoke.KEY)
    for k in (int(x) for x in args.tiles.split(',')):
        st_k = st if k == 0 else dataclasses.replace(st, ray_tile=1 << k)
        traces, steps, imgs = chip_smoke.sorted_divergence(scene, cam, st_k,
                                                           key)
        got, want = imgs['bvh'].numpy(), imgs['auto'].numpy()
        diff, scale = np.abs(got - want), np.abs(want)
        for tr in traces:
            for ex in tr.get('t_examples', ()):
                ex['exact'] = [exact_hit(vertices, face_v, tri, ex['o'],
                                         ex['d']) if tri >= 0 else None
                               for tri in ex['tri']]
        print(json.dumps(dict(
            ray_tile=st_k.ray_tile, traces=traces, bounces=steps,
            pixels_within=float((diff <= 1e-4 + 1e-3 * scale).all(-1)
                                .mean()),
            mean_rel_diff=float(diff.mean() / scale.mean()))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
