"""Wrapper of the Hopper wide-BVH kernel (csrc/bvh_trace.cu).

Replaces raytracer_tpu/ops/traverse.py:bvh_trace (the JAX package's XLA
while-loop tracer, not a Pallas kernel) in all its modes: nearest, any-hit,
the test counters of collect_stats, motion blur, alpha cutouts tested
inside the walk, and two-level scenes. Built and bound as
ops/cuda/cluster_kernel.py builds its kernel (nvcc -fmad=false into a
plain C library, ctypes, PyTorch's current stream); the kernel's arguments
travel as one C struct (`_Args`).

The kernel reads the BVH as records that this module packs from the
scene's tables with plain torch operations: one 128-byte record a node
(`node_records`) and one triangle record a prim_order slot
(`tri_records`). They are kept while every source tensor is the same
tensor at the same version (ops/bundle.cached_levels), so a frame's
launches share them, and an in-place update of the vertices or new tensors
rebuild them. Each ray keeps the first `SHARED` entries of its stack in
shared memory and the rest, up to the scene's stack bound S, in a scratch
tensor allocated here ((S - SHARED) entries a ray, twice that with two
levels: 156 bytes a ray for `sponza_standin`'s S of 71); a BVH whose bound
exceeds `STACK` is refused.

For CUDA tensors `bvh_trace` launches the kernel or raises; for CPU tensors
it runs the plain PyTorch version (ops/traverse.py), which is the kernel's
reference. `LAUNCHES` counts kernel launches, and `MODES` counts them by
mode.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ...core.types import BVHArrays, Scene
from .. import bundle
from .. import intersect as isect
from .. import traverse as plain
from ..intersect import Hit
from .cluster_kernel import check, load, ptr

# the largest stack bound the kernel takes (its scratch is then 1.9 GB for
# a 2,097,152-ray tile, 3.8 GB with two levels), the stack entries a ray
# keeps in shared memory (the rest spill to a scratch tensor of
# (S - SHARED) entries a ray) and the branching factor
STACK = 256
SHARED = 32
BRANCH = 4

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_lib = None

_PTRS = ('nodes', 'tris', 'prim_order', 'm_inv', 'inst_root', 'face_mat',
         'tex_alpha', 'face_t', 'face_has_uv', 'texcoords', 'tex_data',
         'tex_off', 'tex_w', 'tex_h', 'tex_chan', 'o', 'd', 'time', 'tmin',
         'tmax', 't_out', 'tri_out', 'inst_out', 'a_out', 'b_out', 'n_box',
         'n_tri', 'spill')
_INTS = ('n_prim', 'n_inst', 'n_texel', 'R', 'root', 'S', 'K',
         'any_hit', 'stats')


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


def stack_split(bvh: BVHArrays) -> tuple[int, int]:
    """(S, K): the BVH's stack bound (ops/traverse.stack_bound) and the
    entries of it a ray keeps in shared memory; raises when S exceeds
    the kernel's limit."""
    S = plain.stack_bound(bvh)
    if S > STACK:
        raise ValueError(f'bvh_trace: the BVH needs a stack of {S} entries '
                         f'(depth {bvh.depth}); the kernel takes at most '
                         f'{STACK} ({SHARED} a ray in shared memory, the '
                         f'rest in a scratch tensor)')
    return S, min(S, SHARED)


def node_records(bvh: BVHArrays) -> torch.Tensor:
    """(N, 32) float32, one 128-byte record a node: the B children's lo x,
    lo y, lo z, hi x, hi y, hi z rows (B floats each), then child and count
    (B int32s each, their bits)."""
    N, B = bvh.child.shape
    box = lambda x: x.transpose(1, 2).reshape(N, 3 * B)
    return torch.cat([box(bvh.node_min), box(bvh.node_max),
                      bvh.child.contiguous().view(torch.float32),
                      bvh.count.contiguous().view(torch.float32)],
                     1).contiguous()


def tri_records(prim_order, face_v, vertices,
                vertices_t1=None) -> torch.Tensor:
    """One record a prim_order slot, for the triangle it names: (P, 12)
    float32, p0 with the triangle id's bits in its fourth float, then e1 =
    p1 - p0 and e2 = p2 - p0, each padded to four floats; with motion blur
    (vertices_t1 given) (P, 24), the corners p0 (with the id), p1, p2 at
    t0, then at t1, each padded alike. The slots of instance leaves
    (instance ids) get the record of a clamped id, which no walk reads."""
    tri = prim_order.clamp(0, face_v.shape[0] - 1).to(torch.int32)
    f = face_v[tri.long()].long()
    idw = tri.contiguous().view(torch.float32)[:, None]
    zero = torch.zeros_like(idw)
    p0, p1, p2 = (vertices[f[:, k]] for k in range(3))
    if vertices_t1 is None:
        parts = [p0, idw, p1 - p0, zero, p2 - p0, zero]
    else:
        parts = [p0, idw, p1, zero, p2, zero]
        for k in range(3):
            parts += [vertices_t1[f[:, k]], zero]
    return torch.cat(parts, 1).contiguous()


def records(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    """The scene's node and triangle records, built once and kept while
    each source tensor is the same tensor at the same version."""
    bvh, g = scene.blas, scene.geom
    nodes = bundle.cached_levels(
        'bvh_nodes', (bvh.node_min, bvh.node_max, bvh.child, bvh.count),
        lambda: node_records(bvh))
    src = (bvh.prim_order, g.face_v, g.vertices) \
        + ((g.vertices_t1,) if scene.has_motion_blur else ())
    tris = bundle.cached_levels('bvh_tris', src,
                                lambda: tri_records(*src))
    return nodes, tris


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
    if B != BRANCH:
        raise ValueError(f'bvh_trace: the kernel walks {BRANCH}-wide nodes, '
                         f'the scene has {B}')
    S, K = stack_split(bvh)
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    V, T = g.vertices.shape[0], g.face_v.shape[0]
    P = bvh.prim_order.shape[0]
    checks = [('node_min', bvh.node_min, f32, (N, B, 3)),
              ('node_max', bvh.node_max, f32, (N, B, 3)),
              ('child', bvh.child, i32, (N, B)),
              ('count', bvh.count, i32, (N, B)),
              ('prim_order', bvh.prim_order, i32, (P,)),
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
        nt = tp.offset.shape[0]
        checks += [('face_mat', g.face_mat, i32, (T,)),
                   ('tex_alpha', scene.materials.tex_alpha, i32,
                    tuple(scene.materials.tex_alpha.shape)),
                   ('face_t', g.face_t, i32, (T, 3)),
                   ('face_has_uv', g.face_has_uv, torch.bool, (T,)),
                   ('texcoords', g.texcoords, f32,
                    tuple(g.texcoords.shape)),
                   ('tex_data', tp.data, f32, tuple(tp.data.shape))] + [
            (n, getattr(tp, n), i32, (nt,))
            for n in ('offset', 'width', 'height', 'channels')]
    for name, x, dt, shape in checks:
        check(name, x, dt, shape, dev)
    if two and inst.m_inv.data_ptr() % 16:
        raise ValueError('bvh_trace: m_inv must be 16-byte aligned (the '
                         'kernel reads its rows as float4s)')
    nodes, tris = records(scene)
    # the stack entries past K: (S - K) slots a ray, and as many instance
    # ids with two levels
    spill = torch.empty((2 if two else 1) * (S - K) * R, dtype=i32,
                        device=dev) if S > K else None
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
        nodes=ptr(nodes), tris=ptr(tris),
        prim_order=ptr(bvh.prim_order),
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
        **{k: ptr(v) for k, v in out.items()}, spill=ptr(spill),
        n_prim=P, n_inst=inst.root.shape[0] if two else 0,
        n_texel=tp.data.shape[0] if alpha else 0, R=R,
        root=scene.bvh_root, S=S, K=K, any_hit=int(any_hit),
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
