"""Wrapper of the Hopper wide-BVH kernel (csrc/bvh_trace.cu).

Replaces raytracer_tpu/ops/traverse.py:bvh_trace (the JAX package's XLA
while-loop tracer, not a Pallas kernel) in all its modes: nearest, any-hit,
the test counters of collect_stats, motion blur, alpha cutouts tested
inside the walk, and two-level scenes. Built and bound as
ops/cuda/cluster_kernel.py builds its kernel (nvcc -fmad=false into a
plain C library, ctypes, PyTorch's current stream); the kernel's arguments
travel as one C struct (`_Args`).

For CUDA tensors `bvh_trace` launches the kernel or raises; for CPU tensors
it runs the plain PyTorch version (ops/traverse.py), which is the kernel's
reference. `LAUNCHES` counts kernel launches, and `MODES` counts them by
mode.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import Scene
from .. import intersect as isect
from .. import traverse as plain
from ..intersect import Hit
from .cluster_kernel import check, load, ptr

# the kernel's fixed stack (csrc/bvh_trace.cu kStack) and branching factor
STACK = 256
BRANCH = 4

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_lib = None

_PTRS = ('node_min', 'node_max', 'child', 'count', 'prim_order', 'face_v',
         'verts', 'verts_t1', 'm_inv', 'inst_root', 'face_mat', 'tex_alpha',
         'face_t', 'face_has_uv', 'texcoords', 'tex_data', 'tex_off',
         'tex_w', 'tex_h', 'tex_chan', 'o', 'd', 'time', 'tmin', 'tmax',
         't_out', 'tri_out', 'inst_out', 'a_out', 'b_out', 'n_box', 'n_tri')
_INTS = ('n_prim', 'n_inst', 'n_texel', 'R', 'root', 'S', 'any_hit',
         'stats')


class _Args(ctypes.Structure):
    """csrc/bvh_trace.cu's `Args`, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] \
        + [(n, ctypes.c_int) for n in _INTS]


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        _lib = load('bvh_trace', [ctypes.POINTER(_Args), ci, ci, ci, vp])
    return _lib


def mode_name(scene: Scene, any_hit: bool, collect_stats: bool) -> str:
    """A launch's mode: 'nearest' or 'any', with '+two_level', '+mb',
    '+alpha' and '+stats' as they apply."""
    parts = ['any' if any_hit else 'nearest']
    parts += [n for n, on in (('two_level', not scene.single_level),
                              ('mb', scene.has_motion_blur),
                              ('alpha', scene.has_alpha_maps),
                              ('stats', collect_stats)) if on]
    return '+'.join(parts)


def launch(scene: Scene, o, d, time, tmin, tmax, any_hit: bool,
           collect_stats: bool):
    """Run the kernel on CUDA tensors -> (t, tri, inst, a, b, n_box,
    n_tri); the counters are None unless collect_stats."""
    global LAUNCHES
    lib = build()
    bvh, g = scene.blas, scene.geom
    R = o.shape[0]
    N, B = bvh.child.shape
    S = plain.stack_bound(bvh)
    if B != BRANCH:
        raise ValueError(f'bvh_trace: the kernel walks {BRANCH}-wide nodes, '
                         f'the scene has {B}')
    if S > STACK:
        raise ValueError(f'bvh_trace: the BVH needs a stack of {S} entries '
                         f'(depth {bvh.depth}), the kernel has {STACK}')
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    V, T = g.vertices.shape[0], g.face_v.shape[0]
    checks = [('node_min', bvh.node_min, f32, (N, B, 3)),
              ('node_max', bvh.node_max, f32, (N, B, 3)),
              ('child', bvh.child, i32, (N, B)),
              ('count', bvh.count, i32, (N, B)),
              ('prim_order', bvh.prim_order, i32, tuple(bvh.prim_order.shape)),
              ('face_v', g.face_v, i32, (T, 3)),
              ('vertices', g.vertices, f32, (V, 3)),
              ('o', o, f32, (R, 3)), ('d', d, f32, (R, 3)),
              ('time', time, f32, (R,)), ('tmin', tmin, f32, (R,)),
              ('tmax', tmax, f32, (R,))]
    two, mb, alpha = (not scene.single_level, scene.has_motion_blur,
                      scene.has_alpha_maps)
    inst, tp = scene.instances, scene.textures
    if mb:
        checks.append(('vertices_t1', g.vertices_t1, f32, (V, 3)))
    if two:
        I = inst.m_inv.shape[0]
        checks += [('m_inv', inst.m_inv, f32, (I, 3, 4)),
                   ('root', inst.root, i32, (I,))]
    if alpha:
        K = tp.offset.shape[0]
        checks += [('face_mat', g.face_mat, i32, (T,)),
                   ('tex_alpha', scene.materials.tex_alpha, i32,
                    tuple(scene.materials.tex_alpha.shape)),
                   ('face_t', g.face_t, i32, (T, 3)),
                   ('face_has_uv', g.face_has_uv, torch.bool, (T,)),
                   ('texcoords', g.texcoords, f32,
                    tuple(g.texcoords.shape)),
                   ('tex_data', tp.data, f32, tuple(tp.data.shape))] + [
            (n, getattr(tp, n), i32, (K,))
            for n in ('offset', 'width', 'height', 'channels')]
    for name, x, dt, shape in checks:
        check(name, x, dt, shape, dev)
    out = dict(t_out=torch.empty(R, dtype=f32, device=dev),
               tri_out=torch.empty(R, dtype=i32, device=dev),
               inst_out=torch.empty(R, dtype=i32, device=dev),
               a_out=torch.empty(R, dtype=f32, device=dev),
               b_out=torch.empty(R, dtype=f32, device=dev),
               n_box=torch.empty(R, dtype=i32, device=dev)
               if collect_stats else None,
               n_tri=torch.empty(R, dtype=i32, device=dev)
               if collect_stats else None)
    args = _Args(
        node_min=ptr(bvh.node_min), node_max=ptr(bvh.node_max),
        child=ptr(bvh.child), count=ptr(bvh.count),
        prim_order=ptr(bvh.prim_order), face_v=ptr(g.face_v),
        verts=ptr(g.vertices), verts_t1=ptr(g.vertices_t1) if mb else None,
        m_inv=ptr(inst.m_inv) if two else None,
        inst_root=ptr(inst.root) if two else None,
        face_mat=ptr(g.face_mat) if alpha else None,
        tex_alpha=ptr(scene.materials.tex_alpha) if alpha else None,
        face_t=ptr(g.face_t) if alpha else None,
        face_has_uv=ptr(g.face_has_uv) if alpha else None,
        texcoords=ptr(g.texcoords) if alpha else None,
        tex_data=ptr(tp.data) if alpha else None,
        tex_off=ptr(tp.offset) if alpha else None,
        tex_w=ptr(tp.width) if alpha else None,
        tex_h=ptr(tp.height) if alpha else None,
        tex_chan=ptr(tp.channels) if alpha else None,
        o=ptr(o), d=ptr(d), time=ptr(time), tmin=ptr(tmin), tmax=ptr(tmax),
        **{k: ptr(v) for k, v in out.items()},
        n_prim=bvh.prim_order.shape[0], n_inst=inst.root.shape[0]
        if two else 0, n_texel=tp.data.shape[0] if alpha else 0, R=R,
        root=scene.bvh_root, S=S, any_hit=int(any_hit),
        stats=int(collect_stats))
    err = lib.rt_bvh_trace(ctypes.byref(args), int(two), int(mb), int(alpha),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'bvh_trace kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    MODES[mode_name(scene, any_hit, collect_stats)] += 1
    return tuple(out.values())


@torch.no_grad()
def bvh_trace(scene: Scene, o, d, time, tmin, tmax, any_hit: bool = False,
              collect_stats: bool = False):
    """Trace a wavefront against the scene's merged BVH -> Hit (ids and
    detached floats; intersect.refine_hit recomputes differentiably), and
    with collect_stats the per-ray counters {'ray_aabb', 'ray_tri'}."""
    if o.device.type == 'cpu':
        return plain.bvh_trace(scene, o, d, time, tmin, tmax, any_hit,
                               collect_stats)
    if o.device.type != 'cuda':
        raise ValueError(f'bvh_trace: unsupported device {o.device}')
    if scene.blas is None:
        raise ValueError('the scene carries no BVH: build it with bvh=True')
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, inst, a, b, n_box, n_tri = launch(scene, o, d, time, tmin, tmax,
                                              any_hit, collect_stats)
    hit = Hit(t=t, tri=tri, inst=inst, a=a, b=b)
    if collect_stats:
        return hit, dict(ray_aabb=n_box, ray_tri=n_tri)
    return hit
