"""Wrapper of the Hopper cluster-trace kernel (csrc/cluster_trace.cu).

Replaces raytracer_tpu/ops/pallas/cluster_kernel.py:pallas_cluster_trace
in all its modes: nearest, `cheap_any`, `need_ab` (alpha scenes, whose
any-hit rays are traced as nearest ones) and `mb` (a motion-blurred
table). The CUDA source (with the shared header csrc/trace_common.cuh) is
compiled with nvcc into a shared library with a plain C entry point on
first use (into the package's git-ignored build directory) and called
through ctypes on PyTorch's current stream. The wrapper builds the walk's
group levels (ops/bundle.group_levels) from the table's boxes, and keeps
them while the box tensors stay the same (bundle.cached_levels).

For CUDA tensors `cluster_trace` launches the kernel or raises; for CPU
tensors it runs the plain PyTorch version (ops/cluster_trace.py), which is
the kernel's reference. `LAUNCHES` counts kernel launches, and `MODES`
counts them by mode (`mode_name`).
"""
from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil

import torch

from ... import native
from ...core.types import Scene
from .. import bundle
from .. import cluster_trace as plain
from .. import intersect as isect
from ..intersect import Hit
from . import rng_kernel

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'csrc')
# -fmad=false: no multiply-add contraction, so the kernel rounds exactly as
# the plain version does and the two agree bit for bit; -I csrc for the
# shared header (trace_common.cuh); -Xptxas -v prints each kernel's
# registers, spills and shared memory into the build's log
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-I', CSRC, '-Xptxas', '-v']

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_lib = None


def mode_name(any_hit: bool, cheap: bool, need_ab: bool,
              mb: bool = False) -> str:
    """A launch's mode: 'nearest', 'cheap_any' or 'exact_any' (any-hit in
    an alpha scene), with '+need_ab' and an 'mb+' prefix."""
    kind = 'cheap_any' if cheap else 'exact_any' if any_hit else 'nearest'
    return ('mb+' if mb else '') + kind + ('+need_ab' if need_ab else '')


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernel cannot be built')
    return path


def headers() -> tuple[str, ...]:
    """Every header a kernel may include (csrc/*.cuh), for the build hash."""
    return tuple(sorted(glob.glob(os.path.join(CSRC, '*.cuh'))))


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per hash of the source, the headers
    and the flags) into a shared library, load it and declare its C entry
    point rt_<name>, which returns the launch's CUDA error code."""
    lib = ctypes.CDLL(native.build_shared(
        [nvcc()], os.path.join(CSRC, f'{name}.cu'), NVCC_FLAGS, name,
        headers()))
    fn = getattr(lib, f'rt_{name}')
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def build_log(name: str) -> str:
    """What nvcc printed building csrc/<name>.cu (-Xptxas -v: registers,
    spills and shared memory of each kernel); build it first."""
    lib = native.library_path(os.path.join(CSRC, f'{name}.cu'), NVCC_FLAGS,
                              name, headers())
    with open(lib[:-3] + '.log') as f:
        return f.read()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library, and the
    threefry kernel's (rng_kernel.build): every traced path on the card
    draws its random numbers with it, so whatever builds this kernel
    before a clock starts (bench.build_kernels) builds that one too."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('cluster_trace', [vp] * 4 + [ci] * 3 + [vp] * 7
                    + [ci, ci] + [vp] * 5 + [ci, ci, ci] + [vp] * 5)
        rng_kernel.build()
    return _lib


def check(name, x, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f'{name}: expected contiguous {dtype} {shape} on {device}, got '
            f'{x.dtype} {tuple(x.shape)} on {x.device}')


def ptr(x):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def launch(cl, o, d, tmin, tmax, any_hit: bool, time=None, mb: bool = False,
           need_ab: bool = False, mode: str | None = None):
    """Run the kernel on CUDA tensors -> (t, tri, a, b), as
    plain.trace_ids: any_hit is `cheap_any`; mb lerps the table's basis by
    `time`; a, b are None unless need_ab. `mode` names the launch in
    MODES."""
    global LAUNCHES
    lib = build()
    R = o.shape[0]
    M, _, C = cl.p0.shape
    dev = o.device
    f32 = torch.float32
    checks = [('bb_min', cl.bb_min, f32, (M, 3)),
              ('bb_max', cl.bb_max, f32, (M, 3)),
              ('p0', cl.p0, f32, (M, 3, C)), ('e1', cl.e1, f32, (M, 3, C)),
              ('e2', cl.e2, f32, (M, 3, C)),
              ('tri', cl.tri, torch.int32, (M, C)),
              ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
              ('tmin', tmin, f32, (R,)), ('tmax', tmax, f32, (R,))]
    if mb:
        checks += [('p0_t1', cl.p0_t1, f32, (M, 3, C)),
                   ('e1_t1', cl.e1_t1, f32, (M, 3, C)),
                   ('e2_t1', cl.e2_t1, f32, (M, 3, C)),
                   ('time', time, f32, (R,))]
    for name, x, dt, shape in checks:
        check(name, x, dt, shape, dev)
    if R >= 2 ** 31 or M * 3 * C >= 2 ** 31:
        raise ValueError('ray or triangle count exceeds the int32 indexing')
    q = (cl.p0_t1, cl.e1_t1, cl.e2_t1) if mb else ()
    slabs = (cl.p0, cl.e1, cl.e2, cl.tri) + q
    if C % 4 or any(x.data_ptr() % 16 for x in slabs):
        raise ValueError('the cluster slabs are copied in 16-byte pieces: '
                         'C must be a multiple of 4 and the tables aligned')
    # the member boxes and the walk's group levels over them
    box, *levels = bundle.cached_levels(
        'cluster', (cl.bb_min, cl.bb_max), lambda: plain.box_levels(cl))
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    a = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    b = torch.empty(R, dtype=f32, device=dev) if need_ab else None
    q = q + (time,) if mb else (None,) * 4
    err = lib.rt_cluster_trace(
        box.data_ptr(), *(x.data_ptr() for x in levels),
        *(x.shape[1] for x in levels), cl.p0.data_ptr(), cl.e1.data_ptr(),
        cl.e2.data_ptr(), ptr(q[0]), ptr(q[1]), ptr(q[2]),
        cl.tri.data_ptr(), M, C, o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
        tmax.data_ptr(), ptr(q[3]), R, int(any_hit), int(mb), t.data_ptr(),
        tri.data_ptr(), ptr(a), ptr(b),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'cluster_trace kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    MODES[mode or mode_name(any_hit, any_hit, need_ab, mb)] += 1
    return t, tri, a, b


def trace_ids(cl, o, d, tmin, tmax, cheap: bool, time=None, mb: bool = False,
              need_ab: bool = False, mode: str | None = None):
    """(t, tri, a, b) of one table for (R,) tmin and tmax, as
    plain.trace_ids: the kernel for CUDA tensors (`launch`), the plain
    version for CPU ones (counted in plain.CALLS). A round of
    ops/ring_trace.ring_trace is one call."""
    if o.device.type == 'cpu':
        plain.CALLS += 1
        return plain.trace_ids(cl, o, d, tmin, tmax, cheap,
                               time if mb else None, need_ab)
    if o.device.type != 'cuda':
        raise ValueError(f'trace_ids: unsupported device {o.device}')
    return launch(cl, o, d, tmin, tmax, cheap, time, mb, need_ab, mode)


@torch.no_grad()
def cluster_trace(scene: Scene, o, d, time, tmin, tmax,
                  any_hit: bool = False, table=None, mb=None) -> Hit:
    """Trace a wavefront through scene.clusters (or `table`, such as the
    motion-blurred partition scene.mb_clusters; mb defaults to the scene's
    motion-blur flag) -> Hit (ids and detached floats;
    intersect.refine_hit recomputes differentiably)."""
    if o.device.type == 'cpu':
        return plain.cluster_trace(scene, o, d, time, tmin, tmax, any_hit,
                                   table, mb)
    if o.device.type != 'cuda':
        raise ValueError(f'cluster_trace: unsupported device {o.device}')
    cl = scene.clusters if table is None else table
    mb = scene.has_motion_blur if mb is None else mb
    cheap, need_ab = plain.modes(scene, any_hit)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, a, b = launch(cl, o, d, tmin, tmax, cheap, time, mb, need_ab,
                          mode_name(any_hit, cheap, need_ab, mb))
    return plain.finish(scene, o, d, time, t, tri, cheap, a, b)
