"""Where a 1080p frame of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch_frame_profile.py [--scene NAME] [--tiles 17,19,21]
                                           [--trace PATH] [--train]
                                           [--pallas] [--edges] [--bvh]

Renders --scene (default `sponza_standin`: 1 spp, 10 bounces; or
`instanced_grid_standin`, `forest_standin` or `final_forest_standin` at
their own settings, `final_forest_standin_no_trees` for the last without
trees) at 1920x1080 with raytracer_tpu_torch on CUDA. For each ray tile
size 2**k in --tiles it prints the median wall time of 3 renders after a
warm-up. Then it profiles one render at the default tile with
torch.profiler and prints the device time by kernel name, the trace
kernels' time and share, the device busy share (device kernel time over
wall time) and, for alpha scenes, the alpha march's passes and host
syncs. --trace writes the Chrome trace.

--train does the same for one training step (parallel/sharding
.loss_and_grads_scanned: forward + backward to all six parameter leaves
against a zero target): per tile the median wall of 3 steps and the peak
memory (or "oom"); then one profiled step at the largest tile that fits,
split into forward and backward device time with the top kernels of each
and the trace kernels' time; then the backward device time of each leaf
alone (a profiled step whose only leaf that requires grad is that one);
then the backward's gathers by call site: one profiled step with each
take gradient's backward (core/vecmath.take and permute) in a profiler
range named by its site (`sort`, `corners_refine`, `corners_geoN`, `kd`,
`spec_exp`, `tex`), and per site the device ms, the kernels launched and
the ms by kernel name. On a tree whose take has no sites (before the
take-scatter kernel), the script wraps its take calls itself, named by
their caller, with the backward autograd gives index_select (zeros and
index_add_), so that both trees are split alike. --scene
sponza_proxy_hd takes the benchmark's training cell's scene,
`sponza_proxy(hd=True)` on the stand-in asset tree (written into a
temporary directory).
--pallas takes the 'pallas' cell instead: `sponza_standin` cut to 12
spheres (8,836 triangles), intersector 'pallas' (the MT kernel). --bvh
builds the scene with its BVH and traces it with intersector 'bvh' (the
BVH kernel).

--edges profiles one step of the edge trainer instead
(diff/edges.loss_and_grads_with_edges with GI edges, 4,096 edge samples,
against a zero target, at the largest tile of --tiles), part by part,
each ended by a device sync: the interior pass, the extra forward render
of the adjoint, the primary and the GI edge terms. Per part it prints the
wall, the device kernel time, the trace kernels' time and the top
kernels. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu_torch as rt  # noqa: E402
from raytracer_tpu_torch import bench  # noqa: E402
from raytracer_tpu_torch.core import rng  # noqa: E402
from raytracer_tpu_torch.core import vecmath as vm  # noqa: E402
from raytracer_tpu_torch.diff import edges  # noqa: E402
from raytracer_tpu_torch.ops import cluster_trace as ct  # noqa: E402
from raytracer_tpu_torch.parallel import sharding  # noqa: E402
from raytracer_tpu_torch.render import integrator  # noqa: E402
from raytracer_tpu_torch.render import camera as cam_mod  # noqa: E402
from raytracer_tpu_torch.scenes import registry  # noqa: E402
from raytracer_tpu_torch.shading import textures  # noqa: E402

DEFAULT_TILE = 1 << 21      # chip_smoke.py's tile: the whole 1080p frame
# the port's CUDA trace kernels, by the names of their __global__ functions
# (mt_trace_kernel: the MT sweep before it was split in three)
TRACE_KERNEL = re.compile(r'(cluster_trace|iseg_trace|icluster_trace|'
                          r'mt_trace|mt_prep|mt_sweep|mt_resolve|bvh)_kernel')


# the take gradients' call sites, and the functions that call take there
SITES = ('sort', 'corners_refine', 'corners_geoN', 'kd', 'spec_exp', 'tex')
CALLERS = dict(_sort_wavefront='sort', gather_tri_verts='corners_refine',
               hit_attributes='corners_geoN', tex_lookup='tex',
               tex_lookup_batch='tex')


class _RangedTake(torch.autograd.Function):
    """index_select with autograd's own backward of it (index_add_ into
    zeros), in a profiler range named by the call site: a tree's take
    before it named its sites."""

    @staticmethod
    def forward(ctx, x, idx, site):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.site = tuple(x.shape), site
        out = torch.index_select(x, 0, idx.reshape(-1).long())
        return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        with torch.profiler.record_function(ctx.site):
            return g.new_zeros(ctx.shape).index_add_(
                0, idx.reshape(-1).long(),
                g.reshape((-1,) + ctx.shape[1:])), None, None


@contextlib.contextmanager
def site_ranges():
    """Each take gradient's backward in a profiler range named by its call
    site, for the length of the block."""
    if hasattr(vm, 'PROFILE_SITES'):
        vm.PROFILE_SITES = True
        try:
            yield
        finally:
            vm.PROFILE_SITES = False
        return
    take = vm.take

    def ranged(x, idx, *_):
        if not (x.is_floating_point() and x.requires_grad
                and torch.is_grad_enabled()):
            return take(x, idx)
        f = sys._getframe(1)
        while f is not None and f.f_code.co_name not in CALLERS \
                and f.f_code.co_name != '_step':
            f = f.f_back        # out of a comprehension's frame
        name = f.f_code.co_name if f is not None else 'take'
        site = CALLERS.get(name) or (
            ('kd' if x.dim() == 2 else 'spec_exp') if name == '_step'
            else name)
        return _RangedTake.apply(x, idx, site)
    old = vm.take, integrator._take, textures.take
    vm.take = integrator._take = textures.take = ranged
    try:
        yield
    finally:
        vm.take, integrator._take, textures.take = old


def by_site(prof) -> dict:
    """Device ms, kernels and ms by kernel name of each site's ranges: the
    device kernels inside the spans that the ranges' annotations take on
    the device's timeline (one stream, so those are the kernels launched
    in the range)."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in dev
             if e.name in SITES]
    out = {s: dict(device_ms=0.0, kernels=0, ranges=0, by_kernel={})
           for s in SITES}
    for _, _, name in spans:
        out[name]['ranges'] += 1
    spans.sort()
    starts = [a for a, _, _ in spans]
    if not spans:
        # no annotations on the device's timeline: the kernels each
        # range's host operations launched
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU \
                    and e.name in SITES:
                rec = out[e.name]
                rec['ranges'] += 1
                todo = [e]
                while todo:
                    h = todo.pop()
                    todo += h.cpu_children
                    for k in h.kernels:
                        rec['device_ms'] += k.duration / 1e3
                        rec['kernels'] += 1
                        rec['by_kernel'][k.name[:60]] = rec['by_kernel'].get(
                            k.name[:60], 0.0) + k.duration / 1e3
        return out
    for e in dev:
        if e.name in SITES or e.name in ('forward', 'backward'):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.start > spans[i][1]:
            continue
        rec = out[spans[i][2]]
        ms = e.device_time_total / 1e3
        rec['device_ms'] += ms
        rec['kernels'] += 1
        k = e.name[:60]
        rec['by_kernel'][k] = rec['by_kernel'].get(k, 0.0) + ms
    return out


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


def device_events(prof):
    """The device kernels of a profile (not the phase annotations, which
    the profiler also lists on the device's timeline)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in ('forward', 'backward')]


def by_name(events, top=15):
    """(total device us, the `top` kernel names by device time)."""
    acc: dict[str, float] = {}
    for e in events:
        acc[e.name] = acc.get(e.name, 0.0) + e.device_time_total
    total = sum(acc.values())
    return total, sorted(acc.items(), key=lambda kv: -kv[1])[:top]


def train_step(scene, cam, st, params, grad_leaves, tile, backward=True):
    """The scanned step of parallel/sharding, spelled out so a profile can
    mark its phases and a run can differentiate some leaves only: per tile
    the forward render and loss (`forward`), then loss.backward()
    (`backward`) into the leaves in grad_leaves."""
    W, H = st.width, st.height
    R = W * H
    dev = scene.geom.vertices.device
    px, py = cam_mod.pixel_coords(W, H, dev)
    msk = torch.ones(R, device=dev)
    pad = (-R) % tile
    if pad:
        px, py, msk = (torch.cat([x, x.new_zeros(pad)]) for x in (px, py, msk))
    with torch.no_grad():
        base = sharding.apply_params(scene, params)
    leaves = {k: v.detach().requires_grad_(k in grad_leaves)
              for k, v in params.items()}
    key = rng.PRNGKey(0)
    for ti in range(px.shape[0] // tile):
        sl = slice(ti * tile, (ti + 1) * tile)
        with torch.profiler.record_function('forward'), \
                torch.set_grad_enabled(backward):
            s = sharding.apply_params(base, leaves, refresh=False)
            L = sharding._render_local(s, cam, st, 1, px[sl], py[sl],
                                       rng.fold_in(key, ti))
            loss = torch.sum(msk[sl, None] * L ** 2)
        if backward and loss.requires_grad:   # an empty leaf has none
            torch.cuda.synchronize()
            with torch.profiler.record_function('backward'):
                loss.backward()
    torch.cuda.synchronize()


def main_train(args, scene, cam, st) -> int:
    W, H = st.width, st.height
    params = sharding.get_params(scene)
    leaves = set(sharding.PARAM_KEYS)
    fits = {}
    for k in (int(x) for x in args.tiles.split(',') if x):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            med, times = wall(lambda: train_step(scene, cam, st, params,
                                                 leaves, 1 << k))
        except torch.cuda.OutOfMemoryError:
            print(json.dumps({'ray_tile': 1 << k, 'fwd_bwd': 'oom'}))
            continue
        fits[k] = med
        print(json.dumps({
            'ray_tile': 1 << k, 'fwd_bwd_median_s': med, 'wall_s': times,
            'primary_rays_per_s': W * H / med,
            'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9}))
    tile = 1 << max(fits)
    torch.cuda.empty_cache()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        train_step(scene, cam, st, params, leaves, tile)
        wall_s = time.perf_counter() - t0
    bwd_start = min(e.time_range.start for e in prof.events()
                    if e.name == 'backward')
    dev_ev = device_events(prof)
    fwd = [e for e in dev_ev if e.time_range.start < bwd_start]
    bwd = [e for e in dev_ev if e.time_range.start >= bwd_start]
    total_us = sum(e.device_time_total for e in dev_ev)
    # the profiler slows the host: the busy share is also given against
    # the unprofiled median step at this tile
    trace_us = sum(e.device_time_total for e in dev_ev
                   if TRACE_KERNEL.search(e.name))
    rec = {'train_profile_tile': tile, 'profiled_wall_s': wall_s,
           'device_kernel_s': total_us / 1e6,
           'trace_kernel_s': trace_us / 1e6,
           'device_busy_share': total_us / 1e6 / wall_s,
           'device_share_of_unprofiled_step':
               total_us / 1e6 / fits[max(fits)],
           'n_device_kernels': len(dev_ev)}
    for tag, evs in (('forward', fwd), ('backward', bwd)):
        t_us, top = by_name(evs)
        rec[f'{tag}_device_s'] = t_us / 1e6
        rec[f'{tag}_kernels'] = len(evs)
        for name, us in top:
            print(json.dumps({'phase': tag, 'kernel': name[:90],
                              'device_ms': us / 1e3,
                              'share': us / max(t_us, 1e-9)}))
    print(json.dumps(rec))
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or '.', exist_ok=True)
        prof.export_chrome_trace(args.trace)
    # the backward device time of each leaf alone (an empty leaf has no
    # backward pass)
    split = {}
    for k in sharding.PARAM_KEYS + ('all',):
        grad_leaves = leaves if k == 'all' else {k}
        with torch.profiler.profile(activities=acts) as prof:
            train_step(scene, cam, st, params, grad_leaves, tile)
        starts = [e.time_range.start for e in prof.events()
                  if e.name == 'backward']
        split[f'backward_{k}_device_s'] = sum(
            e.device_time_total for e in device_events(prof)
            if starts and e.time_range.start >= min(starts)) / 1e6
    print(json.dumps({'per_leaf_backward': split, 'ray_tile': tile}))
    # the backward's gathers by call site
    with site_ranges(), torch.profiler.profile(activities=acts) as prof:
        train_step(scene, cam, st, params, leaves, tile)
    sites = by_site(prof)
    for site, rec in sites.items():
        print(json.dumps({'take_site': site, **rec}))
    print(json.dumps({'take_sites_device_ms': sum(
        r['device_ms'] for r in sites.values()), 'ray_tile': tile}))
    return 0


def main_edges(args, scene, cam, st) -> int:
    tile = 1 << max(int(x) for x in args.tiles.split(',') if x)
    params = sharding.get_params(scene)
    target = torch.zeros((st.height, st.width, 3), device='cuda')
    key = rng.PRNGKey(0)
    n = 4096
    state = {}

    def adjoint():
        state['s'], state['dL'], state['keys'] = edges.edge_adjoint(
            params, scene, cam, st, target, key)

    parts = (
        ('interior', lambda: sharding.loss_and_grads_scanned(
            params, scene, cam, st, target, key, tile=tile)),
        ('adjoint_render', adjoint),
        ('primary_edges', lambda: edges.edge_sampling_vertex_grad(
            state['s'], cam, st, state['dL'], state['keys']['primary'],
            n_samples=n)),
        ('gi_edges', lambda: edges.gi_edge_vertex_grad(
            state['s'], cam, st, state['dL'], state['keys']['gi'],
            n_samples=max(n, 8192))))

    def step():
        spans = []
        for name, fn in parts:
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                fn()
                torch.cuda.synchronize()
            spans.append((name, time.perf_counter() - t0))
        return spans

    step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        spans = step()
        wall_s = time.perf_counter() - t0
    names = [name for name, _ in parts]
    starts = {e.name: e.time_range.start for e in prof.events()
              if e.name in names}
    edges_at = sorted((starts[k], k) for k in names)
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in names]
    by_part = {k: [] for k in names}
    for e in dev_ev:
        owner = [k for t, k in edges_at if t <= e.time_range.start]
        if owner:
            by_part[owner[-1]].append(e)
    total_us = sum(e.device_time_total for e in dev_ev)
    rec = {'edges_profile_tile': tile, 'profiled_wall_s': wall_s,
           'device_kernel_s': total_us / 1e6,
           'device_busy_share': total_us / 1e6 / wall_s, 'parts': {}}
    for name, w in spans:
        t_us, top = by_name(by_part[name])
        trace_us = sum(e.device_time_total for e in by_part[name]
                       if TRACE_KERNEL.search(e.name))
        rec['parts'][name] = dict(wall_s=w, device_s=t_us / 1e6,
                                  trace_kernel_s=trace_us / 1e6,
                                  n_device_kernels=len(by_part[name]))
        for kname, us in top[:8]:
            print(json.dumps({'part': name, 'kernel': kname[:90],
                              'device_ms': us / 1e3,
                              'share': us / max(t_us, 1e-9)}))
    print(json.dumps(rec))
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or '.', exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--scene', default='sponza_standin',
                    choices=('sponza_standin', 'instanced_grid_standin',
                             'forest_standin', 'final_forest_standin',
                             'final_forest_standin_no_trees',
                             'sponza_proxy_hd'))
    ap.add_argument('--tiles', default='17,19,21')
    ap.add_argument('--trace', default=None)
    ap.add_argument('--train', action='store_true')
    ap.add_argument('--pallas', action='store_true')
    ap.add_argument('--edges', action='store_true')
    ap.add_argument('--bvh', action='store_true')
    args = ap.parse_args()
    assert torch.cuda.is_available(), 'needs a CUDA device'
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    name, kw = args.scene, {}
    if name == 'final_forest_standin_no_trees':
        name, kw = 'final_forest_standin', dict(n_trees=0)
    if args.pallas:
        name, kw = 'sponza_standin', dict(n_spheres=12, intersector='pallas')
    if args.bvh:
        kw.update(bvh=True, intersector='bvh')
    if name == 'sponza_proxy_hd':
        name, kw = 'sponza_proxy', dict(kw, hd=True)
    with bench.asset_tree():
        scene, cam, st = registry.make(name, width=1920, height=1080,
                                       ray_tile=DEFAULT_TILE, **kw)
    if args.train:
        return main_train(args, scene, cam, st)
    if args.edges:
        return main_edges(args, scene, cam, st)
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
    events = device_events(prof)
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    total_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    trace_us = sum(v for n, v in by_name.items() if TRACE_KERNEL.search(n))
    print(json.dumps({'scene': args.scene, 'pallas': args.pallas,
                      'profiled_wall_s': wall_s,
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
