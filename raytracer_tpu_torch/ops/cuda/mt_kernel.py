"""Wrapper of the Hopper brute-force Moller-Trumbore kernel
(csrc/mt_trace.cu), and the `intersector='pallas'` tracer around it.

`mt_trace` replaces raytracer_tpu/ops/pallas/mt_kernel.py:mt_trace_pallas:
for CUDA tensors it launches the kernel (compiled with nvcc on first use
into the package's git-ignored build directory, called through ctypes on
PyTorch's current stream) or raises; for CPU tensors it runs the plain
PyTorch version (ops/mt_trace.py), which is the kernel's reference. The
wrapper decides from R and T whether the kernel splits the triangle range
across blocks (`split`), and allocates the kernel's scratch: the
triangles' float4 rows and, for a split grid, the per-ray merge keys.
`brute_trace` replaces raytracer_tpu/ops/pallas/__init__.py
:pallas_brute_trace. `LAUNCHES` counts the device kernels launched, two
or three a call (`device_launches`), and `MODES` counts them by mode (the
kernel has one: 'nearest').
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import Scene
from .. import intersect as isect
from .. import mt_trace as plain
from ..intersect import Hit
from .cluster_kernel import check, load, ptr

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
BLOCK_RAYS = 512   # rays a block (csrc/mt_trace.cu kBlockRays)
TILE = 256         # triangles a staged tile (csrc/mt_trace.cu kTile)
# a grid fills the card at this many blocks an SM
FILL = 4
_lib = None
_sms: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('mt_trace', [vp] * 4 + [ci] + [vp] * 4 + [ci]
                    + [vp] * 6 + [ci, vp])
    return _lib


def split(R: int, T: int, sms: int) -> int:
    """Triangles per block of the grid's y dimension, a multiple of TILE:
    all of them (one range) when the R rays' blocks alone fill FILL blocks
    an SM of `sms`; else ranges of whole tiles, short enough that there
    are at least as many ranges as the fill needs, or one a tile."""
    ray_blocks = max(1, -(-R // BLOCK_RAYS))
    tiles = max(1, -(-T // TILE))
    parts = max(1, -(-FILL * sms // ray_blocks))
    return max(1, tiles // parts) * TILE


def device_launches(R: int, T: int, per_split: int) -> int:
    """The device kernels a call of R rays and T triangles launches: none
    without rays; else the prep of the float4 rows and merge keys (when
    there are triangles), the sweep and, on a split grid (per_split < T),
    the resolve."""
    return 0 if R == 0 else int(T > 0) + 1 + int(per_split < T)


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
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    per_split = split(R, T, _sms[dev])
    t = torch.empty(R, dtype=f32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    a = torch.empty(R, dtype=f32, device=dev)
    b = torch.empty(R, dtype=f32, device=dev)
    # the float4 triangle rows, and the split grid's merge keys
    tri4 = torch.empty((T, 3, 4), dtype=f32, device=dev)
    keys = torch.empty(R, dtype=torch.int64, device=dev) \
        if per_split < T else None
    err = lib.rt_mt_trace(
        p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), valid.data_ptr(), T,
        o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), R,
        t.data_ptr(), tri.data_ptr(), a.data_ptr(), b.data_ptr(),
        tri4.data_ptr(), ptr(keys), per_split,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'mt_trace kernel launch failed: CUDA error {err}')
    n = device_launches(R, T, per_split)
    LAUNCHES += n
    MODES['nearest'] += n
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
