"""Render observability: BVH stats, ray/test counters, timing reports.

Port of raytracer_tpu/utils/profiling.py. The reference keeps per-thread
counters (Ray::counter, rayTriangleIntersections, BVH::rayBoxIntersections,
src/Ray.h:30-31, src/BVH.h:116) incremented in the hot loops and printed
after the render with its wall time (src/Scene.cpp:202-216); its BVH build
prints node, leaf, depth and faces-per-leaf stats (src/BVH.cpp:563-574).
Here:

  * `bvh_stats(bvh)`: host-side structural stats of the flattened wide BVH;
  * `trace_stats(scene, o, d, ...)`: one wavefront's ray-box and
    ray-triangle test counts, from `bvh_trace(collect_stats=True)` (the
    BVH kernel on the card, its plain version on the CPU);
  * `render_with_stats(...)`: a timed render returning a RenderReport with
    rays/s and, optionally, the test counters of a probe wavefront, as the
    JAX package probes them (through the BVH, whatever tracer the render
    used);
  * `profile_trace(log_dir)`: a torch.profiler scope that writes a Chrome
    trace into log_dir.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from ..core.types import BVHArrays, Camera, RenderSettings, Scene
from ..core.vecmath import EPSILON, MIRO_TMAX
from ..ops.cuda import bvh_kernel
from . import console


def bvh_stats(bvh: BVHArrays) -> dict:
    """Structural stats of a flattened wide BVH (src/BVH.cpp:563-574)."""
    count = bvh.count.cpu().numpy()
    tri_leaves = count > 0
    n_tri_leaves = int(tri_leaves.sum())
    n_tris_ref = int(count[tri_leaves].sum()) if n_tri_leaves else 0
    return dict(
        nodes=count.shape[0],
        branch=count.shape[1],
        tri_leaves=n_tri_leaves,
        inst_leaves=int((count <= -2).sum()),
        internal_children=int((count == 0).sum()),
        tri_refs=n_tris_ref,
        faces_per_leaf=(n_tris_ref / n_tri_leaves) if n_tri_leaves else 0.0,
        max_depth=bvh.depth,
    )


def print_bvh_stats(bvh: BVHArrays) -> None:
    s = bvh_stats(bvh)
    console.info('BVH: %d nodes (%d-wide), %d tri leaves, %d instance '
                 'leaves, %.2f faces/leaf, depth<=%d',
                 s['nodes'], s['branch'], s['tri_leaves'], s['inst_leaves'],
                 s['faces_per_leaf'], s['max_depth'])


def trace_stats(scene: Scene, o, d, time_=0.0, tmin=EPSILON,
                tmax=MIRO_TMAX) -> dict:
    """Ray-box / ray-triangle test counts for one wavefront: totals and
    per-ray means, Python numbers (src/Scene.cpp:202-208). Without a BVH,
    the brute-force count (every ray against every triangle)."""
    R = int(o.shape[0])
    if scene.blas is None:
        return dict(rays=R, ray_aabb=0, ray_tri=R * int(scene.num_tris),
                    aabb_per_ray=0.0, tri_per_ray=float(scene.num_tris))
    _, st = bvh_kernel.bvh_trace(scene, o, d, time_, tmin, tmax,
                                 collect_stats=True)
    aabb = int(st['ray_aabb'].sum())
    tri = int(st['ray_tri'].sum())
    return dict(rays=R, ray_aabb=aabb, ray_tri=tri, aabb_per_ray=aabb / R,
                tri_per_ray=tri / R)


@dataclasses.dataclass
class RenderReport:
    """Post-render stats in the spirit of src/Scene.cpp:211-216."""
    width: int
    height: int
    spp: int
    wall_s: float
    compile_s: float     # the first call's extra time: builds and warm-up
    primary_rays: int
    primary_rays_per_s: float
    probe: dict | None = None  # trace_stats of a probe wavefront

    def pretty(self) -> str:
        lines = [
            f'Rendered {self.width}x{self.height} @ {self.spp}spp '
            f'in {self.wall_s:.3f}s (+{self.compile_s:.1f}s first-call '
            f'builds and warm-up)',
            f'Primary rays cast: {self.primary_rays:,} '
            f'({self.primary_rays_per_s:,.0f} rays/s)',
        ]
        if self.probe:
            lines.append(
                f'Probe wavefront: {self.probe["aabb_per_ray"]:.1f} '
                f'ray/AABB tests, {self.probe["tri_per_ray"]:.1f} '
                f'ray/tri tests per ray')
        return '\n'.join(lines)


def _synced_render(scene, cam, settings, key, spp):
    from ..render import renderer
    t0 = time.perf_counter()
    img = renderer.render(scene, cam, settings, key, spp=spp)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    return img, time.perf_counter() - t0


def render_with_stats(scene: Scene, cam: Camera, settings: RenderSettings,
                      key, spp: int = 1, probe: bool = True,
                      log: bool = True):
    """Timed render -> (image, RenderReport).

    The render runs twice: the second run's wall is `wall_s`, and the
    first run's extra time (kernel builds and warm-up) is `compile_s`.
    With a BVH and probe=True, a probe wavefront of up to 4,096 camera
    rays along the image diagonal is traced with the test counters."""
    from ..render import camera as cam_mod
    img, first = _synced_render(scene, cam, settings, key, spp)
    img, wall = _synced_render(scene, cam, settings, key, spp)
    R = settings.width * settings.height * spp
    probe_stats = None
    if probe and scene.blas is not None:
        dev = scene.geom.vertices.device
        n = min(4096, settings.width * settings.height)
        px = torch.linspace(0, settings.width - 1, n, device=dev)
        py = torch.linspace(0, settings.height - 1, n, device=dev)
        rands = torch.full((n, 5), 0.5, device=dev)
        o, d, tm = cam_mod.eye_rays(cam, settings.width, settings.height,
                                    px, py, 0.0, 1.0, 0.0, 1.0, rands)
        probe_stats = trace_stats(scene, o, d, tm)
    report = RenderReport(
        width=settings.width, height=settings.height, spp=spp,
        wall_s=wall, compile_s=max(first - wall, 0.0), primary_rays=R,
        primary_rays_per_s=R / max(wall, 1e-9), probe=probe_stats)
    if log:
        console.info('%s', report.pretty())
    return img, report


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler scope over everything inside (the CPU, and the card
    when there is one); its Chrome trace is written to
    log_dir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))

