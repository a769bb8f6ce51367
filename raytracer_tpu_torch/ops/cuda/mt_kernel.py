"""Wrapper of the Hopper brute-force Moller-Trumbore kernel
(csrc/mt_trace.cu), and the `intersector='pallas'` tracer around it.

`mt_trace` replaces raytracer_tpu/ops/pallas/mt_kernel.py:mt_trace_pallas:
for CUDA tensors it launches the kernel (compiled with nvcc on first use
into the package's git-ignored build directory, called through ctypes on
PyTorch's current stream) or raises; for CPU tensors it runs the plain
PyTorch version (ops/mt_trace.py), which is the kernel's reference.
`brute_trace` replaces raytracer_tpu/ops/pallas/__init__.py
:pallas_brute_trace. `LAUNCHES` counts kernel launches and `MODES` counts
them by mode (the kernel has one: 'nearest').
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import Scene
from .. import intersect as isect
from .. import mt_trace as plain
from ..intersect import Hit
from .cluster_kernel import check, load

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('mt_trace', [vp] * 4 + [ci] + [vp] * 4 + [ci]
                    + [vp] * 5)
    return _lib


def launch(o, d, p0, p1, p2, valid, tmin, tmax):
    """Run the kernel on CUDA tensors: o, d (R, 3), p0, p1, p2 (T, 3)
    float32, valid (T,) int32, tmin, tmax (R,) float32 -> (t, tri, a, b)."""
    global LAUNCHES
    lib = build()
    R, T = o.shape[0], p0.shape[0]
    dev = o.device
    f32 = torch.float32
    for name, x, dt, shape in (
            ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
            ('p0', p0, f32, (T, 3)), ('p1', p1, f32, (T, 3)),
            ('p2', p2, f32, (T, 3)), ('valid', valid, torch.int32, (T,)),
            ('tmin', tmin, f32, (R,)), ('tmax', tmax, f32, (R,))):
        check(name, x, dt, shape, dev)
    if 3 * R >= 2 ** 31 or 3 * T >= 2 ** 31:
        raise ValueError('ray or triangle count exceeds the int32 indexing')
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    a = torch.empty(R, dtype=f32, device=dev)
    b = torch.empty(R, dtype=f32, device=dev)
    err = lib.rt_mt_trace(
        p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), valid.data_ptr(), T,
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), R,
        t.data_ptr(), tri.data_ptr(), a.data_ptr(), b.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'mt_trace kernel launch failed: CUDA error {err}')
    LAUNCHES += 1
    MODES['nearest'] += 1
    return t, tri, a, b


@torch.no_grad()
def mt_trace(o, d, p0, p1, p2, valid, tmin, tmax):
    """All-pairs nearest hit (the rule of ops/mt_trace.py) -> (t, tri, a,
    b): the kernel for CUDA tensors, the plain version for CPU ones."""
    if o.device.type == 'cpu':
        return plain.mt_trace(o, d, p0, p1, p2, valid, tmin, tmax)
    if o.device.type != 'cuda':
        raise ValueError(f'mt_trace: unsupported device {o.device}')
    f = lambda x: x.detach().to(torch.float32).contiguous()
    return launch(f(o), f(d), f(p0), f(p1), f(p2),
                  valid.to(torch.int32).contiguous(),
                  plain.per_ray(tmin, o), plain.per_ray(tmax, o))


def brute_trace(scene: Scene, o, d, time, tmin, tmax,
                any_hit: bool = False) -> Hit:
    """The `intersector='pallas'` tracer of a single-level scene -> Hit
    (ids and detached floats; intersect.refine_hit recomputes
    differentiably). Each triangle's corners are gathered from the
    (detached) current vertices and swept by mt_trace. any_hit reuses the
    nearest sweep (a hit is a hit; shadow rays read only hit.valid).
    Scenes with motion blur or alpha maps are traced by
    intersect.brute_force_trace instead, as the JAX package routes them
    (raytracer_tpu/ops/pallas/__init__.py:32-38): per-ray lerped corners
    and alpha lookups do not fit the (ray x triangle) sweep."""
    if scene.has_motion_blur or scene.has_alpha_maps:
        return isect.brute_force_trace(scene, o, d, time, tmin, tmax, any_hit)
    with torch.no_grad():
        f = scene.geom.face_v.long()
        v = scene.geom.vertices.detach()
        valid = torch.ones(f.shape[0], dtype=torch.int32, device=v.device)
        t, tri, a, b = mt_trace(o, d, v[f[:, 0]], v[f[:, 1]], v[f[:, 2]],
                                valid, tmin, tmax)
    return Hit(t=t, tri=tri, inst=torch.zeros_like(tri), a=a, b=b)
