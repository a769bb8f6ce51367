"""Wrapper of the Hopper cluster-trace kernel (csrc/cluster_trace.cu).

Replaces raytracer_tpu/ops/pallas/cluster_kernel.py:pallas_cluster_trace for
static single-level scenes, in nearest and any-hit modes. The CUDA source
is compiled with nvcc into a shared library with a plain C entry point on
first use (into the package's git-ignored build directory) and called
through ctypes on PyTorch's current stream.

For CUDA tensors `cluster_trace` launches the kernel or raises; for CPU
tensors it runs the plain PyTorch version (ops/cluster_trace.py), which is
the kernel's reference. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import torch

from ... import native
from ...core.types import Scene
from .. import cluster_trace as plain
from .. import intersect as isect
from ..intersect import Hit

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'csrc')
# -fmad=false: no multiply-add contraction, so the kernel rounds exactly as
# the plain version does and the two agree bit for bit
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']

LAUNCHES = 0
_lib = None


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernel cannot be built')
    return path


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per source hash) into a shared library,
    load it and declare its C entry point rt_<name>, which returns the
    launch's CUDA error code."""
    lib = ctypes.CDLL(native.build_shared(
        [nvcc()], os.path.join(CSRC, f'{name}.cu'), NVCC_FLAGS, name))
    fn = getattr(lib, f'rt_{name}')
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('cluster_trace', [vp, vp, vp, vp, vp, vp, ci, ci, vp, vp,
                                      vp, vp, ci, ci, vp, vp, vp])
    return _lib


def check(name, x, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f'{name}: expected contiguous {dtype} {shape} on {device}, got '
            f'{x.dtype} {tuple(x.shape)} on {x.device}')


def launch(cl, o, d, tmin, tmax, any_hit: bool):
    """Run the kernel on CUDA tensors -> (t, tri), as plain.trace_ids."""
    global LAUNCHES
    lib = build()
    R = o.shape[0]
    M, _, C = cl.p0.shape
    dev = o.device
    f32 = torch.float32
    for name, x, dt, shape in (
            ('bb_min', cl.bb_min, f32, (M, 3)),
            ('bb_max', cl.bb_max, f32, (M, 3)),
            ('p0', cl.p0, f32, (M, 3, C)), ('e1', cl.e1, f32, (M, 3, C)),
            ('e2', cl.e2, f32, (M, 3, C)),
            ('tri', cl.tri, torch.int32, (M, C)),
            ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
            ('tmin', tmin, f32, (R,)), ('tmax', tmax, f32, (R,))):
        check(name, x, dt, shape, dev)
    if R >= 2 ** 31 or M * C >= 2 ** 31:
        raise ValueError('ray or triangle count exceeds the int32 indexing')
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    err = lib.rt_cluster_trace(
        cl.bb_min.data_ptr(), cl.bb_max.data_ptr(), cl.p0.data_ptr(),
        cl.e1.data_ptr(), cl.e2.data_ptr(), cl.tri.data_ptr(), M, C,
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), R,
        int(any_hit), t.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'cluster_trace kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    return t, tri


@torch.no_grad()
def cluster_trace(scene: Scene, o, d, time, tmin, tmax,
                  any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.clusters -> Hit (ids and detached
    floats; intersect.refine_hit recomputes differentiably)."""
    if o.device.type == 'cpu':
        return plain.cluster_trace(scene, o, d, time, tmin, tmax, any_hit)
    if o.device.type != 'cuda':
        raise ValueError(f'cluster_trace: unsupported device {o.device}')
    o, d = o.detach().contiguous(), d.detach().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri = launch(scene.clusters, o, d, tmin, tmax, any_hit)
    return plain.finish(scene, o, d, time, t, tri, any_hit)
