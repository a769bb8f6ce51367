"""Smoke run of raytracer_tpu_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the PyTorch/CUDA port's serving path, a forward render through
`raytracer_tpu_torch.render`, on the 174,724-triangle `sponza_standin`
atrium at 1920x1080, 1 spp, 10 path-traced bounces, in phases:

  1. device: the card's name and power limit; TF32 off;
  2. build: the CUDA cluster-trace kernel and the native host library,
     both compiled from this checkout;
  3. scene: built on the host, moved to the card;
  4. the kernel against its plain PyTorch version, both on the card, at
     32,768 coherent (camera) and incoherent (random) rays, nearest and
     any-hit, with CUDA-event times (median of 5 after a warm-up);
  5. the full 1080p render with intersector 'auto': the kernel must carry
     every trace (launch count > 0, plain-version calls 0); then the median
     wall time of 3 renders;
  6. the same key rendered at 64x48, 3 bounces, on the CPU (plain version)
     and on the card (kernel): the images must agree.

Any failure raises. The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import raytracer_tpu_torch as rt
from raytracer_tpu_torch import native
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops.cuda import cluster_kernel as ck
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.scenes import registry

WIDTH, HEIGHT, BOUNCES = 1920, 1080, 10
# rays per wavefront tile: one tile holds the whole 1080p frame, so every
# bounce is one launch per trace and the frame's per-ray state stays on the
# card (2.65 GB peak; 0.78 s a frame against 1.14 s at 2**19 and 3.71 s at
# 2**17, scripts/torch_frame_profile.py on an H100 80GB HBM3 at 700 W)
RAY_TILE = 1 << 21
N_RAYS = 32_768
PARITY = dict(width=64, height=48, max_bounces=3)
KEY = 2024


def phase(tag: str, **fields) -> None:
    print(json.dumps({'phase': tag, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5) -> tuple[float, object]:
    """Median CUDA-event time of fn() over `reps` runs after a warm-up."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def test_rays(cam, dev):
    """32k coherent camera rays (a 256x128 image of the bench camera) and
    32k incoherent rays (random points in the atrium, random directions)."""
    o, d, _ = cam_mod.center_rays(cam, 256, N_RAYS // 256)
    rs = np.random.default_rng(KEY)
    lo, hi = np.float32([-9.8, 0.05, -4.9]), np.float32([9.8, 7.9, 4.9])
    o2 = lo + rs.uniform(size=(N_RAYS, 3)) * (hi - lo)
    d2 = rs.normal(size=(N_RAYS, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    dist = rs.uniform(0.5, 12.0, N_RAYS)          # any-hit: shadow distances
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return {'coherent': (o.to(dev), d.to(dev), f(dist)),
            'incoherent': (f(o2), f(d2), f(dist))}


def compare_kernel(scene, cam, dev):
    """Phase 4: kernel vs plain on the card -> (max |dt|, ms, plain ms)."""
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    tmax_far = torch.full((N_RAYS,), 1e12, device=dev)
    for kind, (o, d, dist) in test_rays(cam, dev).items():
        for any_hit in (False, True):
            tmax = dist if any_hit else tmax_far
            args = (o, d, 0.0, 1e-3, tmax, any_hit)
            t_k, hk = cuda_ms(lambda: ck.cluster_trace(scene, *args))
            t_p, hp = cuda_ms(lambda: ct.cluster_trace(scene, *args))
            ms_k += t_k
            ms_p += t_p
            hits = int((hp.tri >= 0).sum())
            dt = (hk.t - hp.t).abs()
            t_ok = bool((dt <= 1e-5 * hp.t.abs()).all())
            if any_hit:
                bad = int((hk.valid != hp.valid).sum())
                err = float(dt.max())
            else:
                # tri may differ only at a near-tie: |dt| <= 1e-5 t
                same = hk.tri == hp.tri
                bad = int((~same & (dt > 1e-5 * hp.t.abs())).sum())
                err = float(dt[same].max())
            max_err = max(max_err, err)
            phase('kernel_vs_plain', rays=kind, mode='any' if any_hit
                  else 'nearest', n=N_RAYS, hits=hits,
                  tri_mismatch_not_tie=bad,
                  tri_mismatch=int((hk.tri != hp.tri).sum()),
                  max_abs_dt=err, kernel_ms=t_k, plain_ms=t_p)
            assert bad == 0, f'{kind} any_hit={any_hit}: {bad} rays disagree'
            assert t_ok, f'{kind}: t disagrees beyond rtol 1e-5'
            assert hits > N_RAYS // 20, 'too few hits to compare'
    return max_err, ms_k, ms_p


def check_image(img, shape) -> None:
    assert tuple(img.shape) == shape, img.shape
    assert bool(torch.isfinite(img).all()), 'non-finite pixels'
    assert float(img.min()) >= 0.0, 'negative radiance'
    assert float(img.mean()) > 0.0, 'black image'


def main(dev=None) -> int:
    # ---------------------------------------------------------- 1. device
    assert torch.cuda.is_available(), 'no CUDA device: this smoke run needs one'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dev or torch.device('cuda', 0)
    phase('device', name=torch.cuda.get_device_name(0), smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    ck.build()
    t1 = time.perf_counter()
    native.get_lib()
    t2 = time.perf_counter()
    phase('build', cuda_kernel_s=t1 - t0, native_host_s=t2 - t1)

    # ----------------------------------------------------------- 3. scene
    t0 = time.perf_counter()
    scene_h, cam_h, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=RAY_TILE)
    scene, cam = scene_h.to(dev), cam_h.to(dev)
    torch.cuda.synchronize()
    phase('scene', triangles=scene.num_tris,
          clusters=scene.clusters.num_clusters,
          table_mb=scene.clusters.nbytes / 1e6, ray_tile=st.ray_tile,
          build_s=time.perf_counter() - t0)
    assert scene.num_tris == 174_724

    # ------------------------------------------- 4. kernel against plain
    max_err, ms_k, ms_p = compare_kernel(scene, cam, dev)

    # ------------------------------------------------------ 5. full render
    key = rng.PRNGKey(KEY)
    ck.LAUNCHES = 0
    ct.CALLS = 0
    t0 = time.perf_counter()
    img = rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, plain_calls = ck.LAUNCHES, ct.CALLS
    assert launches > 0, 'the render never launched the kernel'
    assert plain_calls == 0, 'the render called the plain tracer'
    check_image(img, (HEIGHT, WIDTH, 3))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    phase('render_1080p', launches=launches, plain_calls=plain_calls,
          first_s=first_s, wall_s=walls, median_s=wall,
          primary_rays_per_s=WIDTH * HEIGHT / wall,
          mean_radiance=float(img.mean()),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # ------------------------------------------------- 6. CPU/GPU parity
    scene_s, cam_s, st_s = registry.sponza_standin(**PARITY)
    img_cpu = rt.render(scene_s, cam_s, st_s, key).numpy()
    launches0 = ck.LAUNCHES
    img_gpu = rt.render(scene_s.to(dev), cam_s.to(dev), st_s, key).cpu()
    assert ck.LAUNCHES > launches0
    check_image(img_gpu, (PARITY['height'], PARITY['width'], 3))
    img_gpu = img_gpu.numpy()
    diff = np.abs(img_gpu - img_cpu)
    within = float((diff <= 1e-4 + 1e-3 * np.abs(img_cpu)).all(-1).mean())
    rel = float(diff.mean() / np.abs(img_cpu).mean())
    phase('cpu_gpu_parity', pixels_within=within, mean_rel_diff=rel)
    assert within >= 0.99 and rel < 1e-3, 'CPU and GPU renders disagree'

    print(json.dumps({'kernels': [{
        'name': 'cluster_trace', 'route': 'cuda',
        'source': 'raytracer_tpu_torch/csrc/cluster_trace.cu',
        'replaces': 'raytracer_tpu/ops/pallas/cluster_kernel.py:293',
        'launches': launches, 'max_abs_err': max_err, 'ms': ms_k,
        'plain_ms': ms_p}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
