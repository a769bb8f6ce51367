"""Wrapper of the Hopper segment-trace kernel (csrc/iseg_trace.cu).

Replaces raytracer_tpu/ops/pallas/iseg_kernel.py:pallas_iseg_trace for
instanced scenes with shallow prototypes, in all its modes: nearest,
`cheap_any` and `need_ab` (alpha scenes, whose any-hit rays are traced as
nearest ones). Built and bound as ops/cuda/cluster_kernel.py builds its kernel
(nvcc -fmad=false into a plain C library, ctypes, PyTorch's current
stream). Beside the table the kernel takes the walk's group levels, the
real lanes of each pool row and the route of the pool's rows into shared
memory (`walk_tables`), kept while the table's tensors stay the same
(bundle.cached_levels).

For CUDA tensors `iseg_trace` launches the kernel or raises; for CPU tensors
it runs the plain PyTorch version (ops/iseg_trace.py), which is the
kernel's reference. `LAUNCHES` counts kernel launches,
and `MODES` counts them by mode.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import Scene
from .. import intersect as isect
from .. import iseg_trace as plain
from ..bundle import cached_levels
from ..cluster_trace import modes
from ..intersect import Hit
from .cluster_kernel import check, load, mode_name, ptr

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
# the resident route: a pool whose real rows' slabs (10 C floats each) fit
# in this many bytes is copied whole into each block's shared memory; a
# larger one is staged row by row per warp. On an H100
# (scripts/torch_iseg_routes.py) the resident route won on the
# 100,000-instance grid's 40 KB pool (its 1080p frame's kernel time 18.5
# against 19.5 ms) and lost on the tree-less final forest's 70 KB pool
# (39.1 against 32.6 ms): the cut lies between the two
RESIDENT_BYTES = 48 * 1024
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('iseg_trace', [vp] * 5 + [ci] * 5 + [vp] * 8 + [ci] * 3
                    + [vp] * 4 + [ci, ci] + [vp] * 6)
    return _lib


def row_lanes(tri):
    """(Mtot, C) pool tri ids -> (Mtot,) int32 real lanes of each row (the
    kernel tests a row up to its count: real lanes come first)."""
    return (tri >= 0).sum(1).to(torch.int32)


def pool_slots(lanes, C: int):
    """The kernel's route for a pool with `lanes` real lanes a row ->
    (slot, n_slots): slot (Mtot,) int32 numbers the rows with real lanes
    0, 1, ... in row order, -1 for the others, when their slabs fit in
    RESIDENT_BYTES (the resident route, n_slots of them); else n_slots = 0
    (each warp stages the rows it visits)."""
    real = lanes > 0
    n_slots = int(real.sum())
    if n_slots * 10 * C * 4 > RESIDENT_BYTES:
        return torch.full_like(lanes, -1), 0
    slot = torch.cumsum(real.to(torch.int32), 0, dtype=torch.int32) - 1
    return torch.where(real, slot, -1).to(torch.int32), n_slots


def walk_tables(icl):
    """What the kernel walks besides the table: the (6, n) boxes of the
    real segments and their SEG_DEPTH group levels, the real lanes of each
    pool row and the route (pool_slots)."""
    E = icl.num_entries
    lanes = row_lanes(icl.tri)
    slot, n_slots = pool_slots(lanes, icl.tri.shape[1])
    return ([icl.sbb[:, :E].contiguous()] + plain.segment_levels(icl), lanes,
            slot, n_slots)


def launch(icl, o, d, tmin, tmax, any_hit: bool, need_ab: bool = False,
           mode: str | None = None):
    """Run the kernel on CUDA tensors -> (t, tri, inst, a, b), as
    plain.trace_ids: any_hit is `cheap_any`, and a, b are None unless
    need_ab. `mode` names the launch in MODES."""
    global LAUNCHES
    lib = build()
    R = o.shape[0]
    E = icl.sbb.shape[1]
    Mtot, C = icl.tri.shape
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ('sbb', icl.sbb, f32, (6, E)), ('smeta', icl.smeta, i32, (E, 3)),
            ('strf', icl.strf, f32, (E, 12)),
            ('p0', icl.p0, f32, (Mtot * 3, C)),
            ('e1', icl.e1, f32, (Mtot * 3, C)),
            ('e2', icl.e2, f32, (Mtot * 3, C)),
            ('tri', icl.tri, i32, (Mtot, C)),
            ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
            ('tmin', tmin, f32, (R,)), ('tmax', tmax, f32, (R,))):
        check(name, x, dt, shape, dev)
    if R >= 2 ** 31 or Mtot * 3 * C >= 2 ** 31 or E * 12 >= 2 ** 31:
        raise ValueError('ray or table size exceeds the int32 indexing')
    pool = (icl.p0, icl.e1, icl.e2, icl.tri)
    if C % 4 or any(x.data_ptr() % 16 for x in pool):
        raise ValueError('the pool rows are copied in 16-byte pieces: C must '
                         'be a multiple of 4 and the pool aligned')
    boxes, lanes, slot, n_slots = cached_levels(
        'segments', (icl.sbb, icl.tri), lambda: walk_tables(icl))
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=i32, device=dev)
    inst = torch.empty(R, dtype=i32, device=dev)
    a = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    b = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    err = lib.rt_iseg_trace(
        *(x.data_ptr() for x in boxes), *(x.shape[1] for x in boxes),
        icl.smeta.data_ptr(), icl.strf.data_ptr(), icl.p0.data_ptr(),
        icl.e1.data_ptr(), icl.e2.data_ptr(), icl.tri.data_ptr(),
        lanes.data_ptr(), slot.data_ptr(), Mtot, n_slots, C, o.data_ptr(),
        d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), R, int(any_hit),
        t.data_ptr(), tri.data_ptr(), inst.data_ptr(), ptr(a), ptr(b),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'iseg_trace kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    MODES[mode or mode_name(any_hit, any_hit, need_ab)] += 1
    return t, tri, inst, a, b


@torch.no_grad()
def iseg_trace(scene: Scene, o, d, time, tmin, tmax,
               any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.iclusters' segment table -> Hit (ids
    and detached floats; intersect.refine_hit recomputes differentiably)."""
    if o.device.type == 'cpu':
        return plain.iseg_trace(scene, o, d, time, tmin, tmax, any_hit)
    if o.device.type != 'cuda':
        raise ValueError(f'iseg_trace: unsupported device {o.device}')
    cheap, need_ab = modes(scene, any_hit)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, inst, a, b = launch(scene.iclusters, o, d, tmin, tmax, cheap,
                                need_ab, mode_name(any_hit, cheap, need_ab))
    return plain.finish(scene, o, d, time, t, tri, inst, cheap, a, b)
