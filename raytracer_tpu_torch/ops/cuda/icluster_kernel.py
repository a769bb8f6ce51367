"""Wrapper of the Hopper hierarchical instance-trace kernel
(csrc/icluster_trace.cu).

Replaces raytracer_tpu/ops/pallas/icluster_kernel.py:pallas_icluster_trace
for instanced scenes with deep prototypes, in all its modes: nearest,
`cheap_any` and `need_ab` (alpha scenes, whose any-hit rays are traced as
nearest ones). Built and bound as ops/cuda/cluster_kernel.py builds its kernel
(nvcc -fmad=false into a plain C library, ctypes, PyTorch's current
stream).

For CUDA tensors `icluster_trace` launches the kernel or raises; for CPU
tensors it runs the plain PyTorch version (ops/icluster_trace.py), which is
the kernel's reference. `LAUNCHES` counts kernel launches,
and `MODES` counts them by mode.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import Scene
from .. import icluster_trace as plain
from .. import intersect as isect
from ..bundle import cached_levels
from ..cluster_trace import modes
from ..intersect import Hit
from ..iseg_trace import finish
from .cluster_kernel import check, load, mode_name, ptr


LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('icluster_trace',
                    [vp] * 4 + [ci] * 5 + [vp] * 10 + [ci] * 4 + [vp] * 4
                    + [ci, ci] + [vp] * 6)
    return _lib


def walk_levels(icl):
    """The walk's group levels of the instance boxes and of the
    prototypes' cluster boxes, kept while those tensors stay the same
    (bundle.cached_levels: the 77 launches of a final forest frame
    share them; refresh_iclusters makes new ones)."""
    return (cached_levels('instances', (icl.ibb,),
                          lambda: plain.instance_levels(icl)),
            cached_levels('prototypes', (icl.pbb,),
                          lambda: plain.proto_levels(icl.pbb)))


def launch(icl, o, d, tmin, tmax, any_hit: bool, need_ab: bool = False,
           mode: str | None = None):
    """Run the kernel on CUDA tensors -> (t, tri, inst, a, b), as
    plain.trace_ids: any_hit is `cheap_any`, and a, b are None unless
    need_ab. `mode` names the launch in MODES."""
    global LAUNCHES
    lib = build()
    R = o.shape[0]
    I = icl.ibb.shape[1]
    P = icl.pmeta.shape[0]
    MP = icl.pbb.shape[1]
    Mtot, C = icl.tri.shape
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ('ibb', icl.ibb, f32, (6, I)), ('iminv', icl.iminv, f32, (I, 12)),
            ('imeta', icl.imeta, i32, (I, 2)),
            ('pbb', icl.pbb, f32, (P * 6, MP)),
            ('pmeta', icl.pmeta, i32, (P, 2)),
            ('p0', icl.p0, f32, (Mtot * 3, C)),
            ('e1', icl.e1, f32, (Mtot * 3, C)),
            ('e2', icl.e2, f32, (Mtot * 3, C)),
            ('tri', icl.tri, i32, (Mtot, C)),
            ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
            ('tmin', tmin, f32, (R,)), ('tmax', tmax, f32, (R,))):
        check(name, x, dt, shape, dev)
    if R >= 2 ** 31 or Mtot * 3 * C >= 2 ** 31 or I * 12 >= 2 ** 31:
        raise ValueError('ray or table size exceeds the int32 indexing')
    ilevels, plevels = walk_levels(icl)
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=i32, device=dev)
    inst = torch.empty(R, dtype=i32, device=dev)
    a = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    b = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    err = lib.rt_icluster_trace(
        icl.ibb.data_ptr(), *(x.data_ptr() for x in ilevels), I,
        icl.num_instances, *(x.shape[1] for x in ilevels),
        icl.iminv.data_ptr(), icl.imeta.data_ptr(), icl.pbb.data_ptr(),
        *(x.data_ptr() for x in plevels), icl.pmeta.data_ptr(),
        icl.p0.data_ptr(), icl.e1.data_ptr(), icl.e2.data_ptr(),
        icl.tri.data_ptr(), MP, *(x.shape[1] for x in plevels), C,
        o.data_ptr(), d.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), R, int(any_hit), t.data_ptr(),
        tri.data_ptr(), inst.data_ptr(), ptr(a), ptr(b),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'icluster_trace kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    MODES[mode or mode_name(any_hit, any_hit, need_ab)] += 1
    return t, tri, inst, a, b


@torch.no_grad()
def icluster_trace(scene: Scene, o, d, time, tmin, tmax,
                   any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.iclusters' instance and prototype
    tables -> Hit (ids and detached floats; intersect.refine_hit recomputes
    differentiably)."""
    if o.device.type == 'cpu':
        return plain.icluster_trace(scene, o, d, time, tmin, tmax, any_hit)
    if o.device.type != 'cuda':
        raise ValueError(f'icluster_trace: unsupported device {o.device}')
    cheap, need_ab = modes(scene, any_hit)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, inst, a, b = launch(scene.iclusters, o, d, tmin, tmax, cheap,
                                need_ab, mode_name(any_hit, cheap, need_ab))
    return finish(scene, o, d, time, t, tri, inst, cheap, a, b)
