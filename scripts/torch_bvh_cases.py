"""The wide-BVH kernel (csrc/bvh_trace.cu) timed at its two sizes, on one
GPU:

    python3 scripts/torch_bvh_cases.py

Builds `sponza_standin` at 1920x1080 with its BVH on the card, then for
each case traces the rays through the plain walk (ops/traverse.bvh_trace,
on the card) once and through the kernel (ops/cuda/bvh_kernel.bvh_trace):
the CUDA-event ms of the wrapper's call (median of 5 after a warm-up;
at 32k rays mostly the host's work before the launch), the kernel's own
device time (torch.profiler, mean of 5 calls), its results
against the plain walk's (t, tri, inst, a, b and the box and triangle
counters, bit for bit: the script fails otherwise), and the counters'
mean tests a ray. The cases: 32,768 coherent rays (a 256 x 128 image of
the camera) and 32,768 incoherent ones (from around the vertex box to
random points in it), nearest, then any-hit stopping at 0.5-1.5 times
the nearest hit; and the 1080p frame's wavefront, its 2,073,600 camera
rays (nearest) and one bounce from their hits, random directions, sorted
as the integrator sorts a wavefront, stopping at 0.5-12 units (any-hit);
then `mb_prototype_standin` at 1080 x 1080 (two levels and motion blur,
the scene that intersector 'auto' traces through this kernel), its camera
rays (nearest).

Each case's least time on the card, the larger of its bytes (each table
byte once: node_min, node_max, child, count, prim_order, face_v,
vertices, and vertices_t1, m_inv and the instances' roots where the scene
has them; 56 bytes of rays in and out a ray) over 3.35 TB/s and its
operations (24 a box test, 45 a triangle test and 27 more for a
motion-blurred one, from the walk's own counters) over 67 TFLOP/s, is
printed beside it. One JSON line a case,
then the card's name and power limit. Runs the same on a tree before the
kernel's redesign (scripts/torch_parent_vs_change.sh copies it there).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from raytracer_tpu_torch.ops import traverse as ttr  # noqa: E402
from raytracer_tpu_torch.ops.cuda import bvh_kernel as bvk  # noqa: E402
from raytracer_tpu_torch.render import camera as cam_mod  # noqa: E402
from raytracer_tpu_torch.render import integrator  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402

N_RAYS = 32_768
WIDTH, HEIGHT = 1920, 1080
SEED = 2024
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
BOX_OPS, MT_OPS = 24, 45
RAY_BYTES = 56
LERP_OPS = 27     # the motion-blur lerp of a triangle's nine corner values


def cuda_ms(fn, reps: int = 5) -> tuple[float, object]:
    """Median CUDA-event ms of fn() over `reps` runs after a warm-up."""
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


def kernel_ms(fn, reps: int = 5) -> float:
    """The mean device time of the BVH kernel itself in `reps` calls of
    fn() (torch.profiler; the wrapper's host work left out)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if 'bvh_kernel' in e.key)
    return us / reps / 1e3


def cases(scene, cam, dev):
    """(name, o, d, tmax, any_hit) for every case, the any-hit ones after
    the nearest ones whose hits they start from or stop at."""
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    rs = np.random.default_rng(SEED)
    v = scene.geom.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    o, d, _ = cam_mod.center_rays(cam, 256, N_RAYS // 256)
    o2 = (lo + hi) / 2 + rs.normal(size=(N_RAYS, 3)) * (hi - lo).max()
    d2 = unit(lo + rs.uniform(size=(N_RAYS, 3)) * (hi - lo) - o2)
    far = torch.full((N_RAYS,), 1e12, device=dev)
    for kind, oo, dd in (('coherent', o.to(dev), d.to(dev)),
                         ('incoherent', f(o2), f(d2))):
        yield f'32k_{kind}_nearest', oo, dd, far, False
        near = ttr.bvh_trace(scene, oo, dd, 0.0, 1e-3, far)
        u = f(rs.uniform(0.5, 1.5, N_RAYS))
        yield (f'32k_{kind}_any', oo, dd,
               torch.clamp(near.t * u, max=1e12), True)
    o, d, _ = cam_mod.center_rays(cam, WIDTH, HEIGHT)
    o, d = o.to(dev), d.to(dev)
    R = o.shape[0]
    far = torch.full((R,), 1e12, device=dev)
    yield 'frame_nearest', o, d, far, False
    first = ttr.bvh_trace(scene, o, d, 0.0, 1e-3, far)
    alive = first.tri >= 0
    b = integrator._sort_wavefront({
        'o': torch.where(alive[:, None], o + first.t[:, None] * d, o),
        'd': f(unit(rs.normal(size=(R, 3)))), 'alive': alive,
        'tmax': torch.where(alive, f(rs.uniform(0.5, 12.0, R)), -1.0)})
    yield 'frame_bounce_any', b['o'], b['d'], b['tmax'], True


def proto_case(dev):
    """The motion-blurred prototype (the scene 'auto' sends to this kernel)
    and its 1080 x 1080 camera rays, nearest."""
    scene, cam, _ = registry.mb_prototype_standin(size=HEIGHT, device=dev)
    o, d, _ = cam_mod.center_rays(cam, HEIGHT, HEIGHT)
    far = torch.full((o.shape[0],), 1e12, device=dev)
    return scene, ('mb_prototype_frame_nearest', o.to(dev), d.to(dev), far,
                   False)


def table_bytes(scene) -> int:
    """The bytes of the tables the walk reads, each once."""
    bvh, g = scene.blas, scene.geom
    xs = [bvh.node_min, bvh.node_max, bvh.child, bvh.count, bvh.prim_order,
          g.face_v, g.vertices]
    if scene.has_motion_blur:
        xs.append(g.vertices_t1)
    if not scene.single_level:
        xs += [scene.instances.m_inv, scene.instances.root]
    return sum(x.numel() * x.element_size() for x in xs)


def main() -> int:
    assert torch.cuda.is_available(), 'needs a CUDA device'
    dev = torch.device('cuda', 0)
    bvk.build()
    sponza, cam, _ = registry.sponza_standin(WIDTH, HEIGHT, bvh=True,
                                             device=dev)
    proto, last = proto_case(dev)
    for case, o, d, tmax, any_hit in list(cases(sponza, cam, dev)) + [last]:
        scene = proto if case.startswith('mb_prototype') else sponza
        R = o.shape[0]
        call = lambda stats: (lambda: bvk.bvh_trace(
            scene, o, d, 0.0, 1e-3, tmax, any_hit, stats))
        hp, sp = ttr.bvh_trace(scene, o, d, 0.0, 1e-3, tmax, any_hit, True)
        box, tri = int(sp['ray_aabb'].sum()), int(sp['ray_tri'].sum())
        lerp = LERP_OPS if scene.has_motion_blur else 0
        ops_ms = (box * BOX_OPS + tri * (MT_OPS + lerp)) / PEAK_FLOPS * 1e3
        bytes_ms = (table_bytes(scene) + R * RAY_BYTES) / PEAK_BYTES * 1e3
        hk, sk = call(True)()
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(hk, k), getattr(hp, k))
                   for k in ('t', 'tri', 'inst', 'a', 'b')) and all(
            torch.equal(sk[k], sp[k]) for k in ('ray_aabb', 'ray_tri'))
        ms, _ = cuda_ms(call(False))
        print(json.dumps(dict(
            case=case, rays=R, ms=ms, kernel_ms=kernel_ms(call(False)),
            bit_for_bit=same, hits=int((hp.tri >= 0).sum()),
            box_tests_per_ray=box / R, tri_tests_per_ray=tri / R,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by='operations' if ops_ms >= bytes_ms else 'bytes',
            ops_ms=ops_ms, bytes_ms=bytes_ms)), flush=True)
        assert same, f'{case}: the kernel and the plain walk differ'
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
