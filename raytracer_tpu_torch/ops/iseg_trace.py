"""The flat two-level (segment) tracer in plain PyTorch: the reference for
the CUDA kernel csrc/iseg_trace.cu.

Same inputs and outputs as the JAX package's Pallas kernel
(raytracer_tpu/ops/pallas/iseg_kernel.py:pallas_iseg_trace) and its
outcome, ray for ray:
  * a segment is one (instance, run of KIN prototype clusters) entry of
    scene.iclusters, with a world box; each ray visits the segments in
    table order and tests one whose box entry key max(near, 0) beats its
    best t. It moves the ray into the segment's object space with the
    segment's world -> object affine, each row summed as
    m0*ox + m1*oy + m2*oz + m3 (iseg_kernel.py:143-148); the direction is
    not renormalised, so t is the same in both spaces. It then
    Moller-Trumbore-tests the KIN*C lanes of the run;
  * a hit replaces the best only with a strictly smaller t, so the first
    segment in table order and the lowest lane inside it win ties. This is
    the Pallas kernel's batch argmin (first lane of a pass, passes in lane
    order) followed by its slice merge (a later slice wins only on a
    strictly smaller t, iseg_kernel.py:376-404): one pass over the whole
    table gives the same hits, so the TPU's slicing is not carried over;
  * the reciprocal clamp, the best-t start min(tmax, MIRO_TMAX) and the
    miss outputs are the single-level kernel's (ops/cluster_trace.py);
    `cheap_any` returns tri = 1 (a hit flag, not an id) and
    t = min(tmax, MIRO_TMAX) for a hit (iseg_kernel.py:199-202);
  * in a scene with alpha maps every trace is `need_ab`: the winning
    lane's own a and b, computed in the instance's object space, come back
    (iseg_kernel.py:226-228); and any-hit is exact, the nearest hit, as in
    ops/cluster_trace.py. Otherwise, in nearest mode a and b are
    recomputed in the hit instance's object space from the winning
    triangle, as the JAX wrapper does (iseg_kernel.py:412-428).
Rays in 32-ray blocks that cannot reach the table's box are culled first
(ops/bundle.py, as the JAX wrapper does per slice); the cull is
conservative, so it changes no hit.

Vectorised over rays, with the CUDA kernel's cull: the segments are
walked over four levels of fan-out-8 union boxes in table order
(bundle.group_levels; cluster_trace.walk), in chunks of one 512-segment
group, a segment's key computed only where its groups' keys beat the best
t. Each chunk's (ray, segment) pairs whose box passes are tested together
against the best t of the chunk's start, which tests a superset of the
sequential visit and only adds hits that lose to the best; a group's key
never exceeds a member's, so the cull drops nothing the flat scan keeps.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from ..geometry.clusters import KIN
from . import bundle
from . import intersect as isect
from .cluster_trace import (_mt, modes, rcp, reduce_best,  # noqa: F401
                            slab_keys, walk)
from .intersect import Hit

PAIR_CHUNK = 4096
# the segment kernel's group walk (csrc/iseg_trace.cu kFan, kDepth): four
# levels of fan-out-8 union boxes over table order (8, 64, 512 and 4,096
# segments; a 100,000-instance grid's 200,000 segments give a top level of
# 49 groups)
SEG_GROUP = 8
SEG_DEPTH = 4

# number of calls of the plain version, so a run can show which path it took
CALLS = 0


def to_object(m, o, d):
    """World -> object space with (P, 12) affine rows, in the kernels'
    order: m0*ox + m1*oy + m2*oz + m3 -> (o', d'), each (P, 3)."""
    oo = [m[:, 4 * i] * o[:, 0] + m[:, 4 * i + 1] * o[:, 1]
          + m[:, 4 * i + 2] * o[:, 2] + m[:, 4 * i + 3] for i in range(3)]
    dd = [m[:, 4 * i] * d[:, 0] + m[:, 4 * i + 1] * d[:, 1]
          + m[:, 4 * i + 2] * d[:, 2] for i in range(3)]
    return torch.stack(oo, 1), torch.stack(dd, 1)


def pool_slabs(icl, rows):
    """MT basis and ids of pool clusters rows (P, k) -> p0, e1, e2
    (P, 3, k*C) and tri (P, k*C), lanes cluster-major."""
    P, k = rows.shape
    C = icl.tri.shape[1]
    comp = 3 * rows[:, :, None] + torch.arange(3, device=rows.device)

    def basis(x):                                   # (P, k, 3, C)
        return x[comp].transpose(1, 2).reshape(P, 3, k * C)
    return (basis(icl.p0), basis(icl.e1), basis(icl.e2),
            icl.tri[rows].reshape(P, k * C))


def segment_levels(icl):
    """The SEG_DEPTH group levels of the segment boxes (8, 64, 512 and
    4,096 segments), over the num_entries real ones."""
    return bundle.group_levels(icl.sbb[:, :icl.num_entries], SEG_GROUP,
                               SEG_DEPTH)


def trace_ids(icl, o, d, tmin, tmax, any_hit: bool, need_ab: bool = False):
    """(t, tri, inst, a, b) of the visiting rule above, for (R,) float32
    tmin, tmax; any_hit is `cheap_any`, and a, b are None unless
    need_ab."""
    R = o.shape[0]
    C = icl.tri.shape[1]
    KC = KIN * C
    E = icl.num_entries
    dev = o.device
    inv = rcp(d)
    tmax = bundle.cull_tmax(o, d, tmin, tmax, icl.sbb)
    best_t0 = torch.clamp(tmax, max=MIRO_TMAX)
    best_t = best_t0.clone()
    best_key = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_a = torch.zeros(R, device=dev) if need_ab else None
    best_b = torch.zeros(R, device=dev) if need_ab else None
    kin = torch.arange(KIN, device=dev)

    def best():
        return torch.where(best_key >= 0, -torch.inf, best_t) if any_hit \
            else best_t
    # chunks of one group of the level below the top (512 segments)
    for ri, ei in walk(icl.sbb[:, :E], segment_levels(icl), o, inv, tmin,
                       tmax, best, SEG_GROUP, SEG_DEPTH - 1):
        for p in range(0, ri.shape[0], PAIR_CHUNK):
            r = ri[p:p + PAIR_CHUNK]
            e = ei[p:p + PAIR_CHUNK]
            oo, dd = to_object(icl.strf[e], o[r], d[r])
            rows = icl.smeta[e, 1].long()[:, None] + kin
            p0, e1, e2, tid = pool_slabs(icl, rows)
            real = tid >= 0
            t, a, b, det = _mt(oo[:, :, None], dd[:, :, None], p0, e1, e2,
                               real)
            ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
                & (det != 0.0) & real \
                & (t >= tmin[r, None]) & (t < best_t[r, None])
            if any_hit:
                best_key[r[ok.any(dim=1)]] = 0
                continue
            best_t, best_key = reduce_best(
                r, t, ok, e * KC, best_t, best_key, R,
                (a, b, best_a, best_b) if need_ab else None)
    got = best_key >= 0
    miss_t = torch.full_like(best_t, MIRO_TMAX)
    if any_hit:
        return (torch.where(got, best_t0, miss_t),
                torch.where(got, 1, -1).to(torch.int32),
                torch.zeros(R, dtype=torch.int32, device=dev), None, None)
    k = best_key.clamp(min=0)
    e, lane = k // KC, k % KC
    row = icl.smeta[e, 1].long() + lane // C
    tri = torch.where(got, icl.tri[row, lane % C], -1).to(torch.int32)
    inst = torch.where(got, icl.smeta[e, 2], 0).to(torch.int32)
    return torch.where(got, best_t, miss_t), tri, inst, best_a, best_b


def finish(scene: Scene, o, d, time, t, tri, inst, any_hit: bool, a=None,
           b=None) -> Hit:
    """Hit from the traced (t, tri, inst): the tracer's own a and b when
    it returned them (need_ab), else in nearest mode the barycentrics
    recomputed from the winning triangle in the hit instance's object
    space, as the JAX wrappers do."""
    zeros = torch.zeros_like(t)
    if a is not None:
        return Hit(t=t, tri=tri, inst=inst, a=a, b=b)
    if any_hit:
        return Hit(t=t, tri=tri, inst=inst, a=zeros, b=zeros)
    p = isect.gather_tri_verts(scene, tri.clamp(min=0), time)
    mi = scene.instances.m_inv[inst.long()]
    _, a, b, _ = isect.mt_intersect(vm.transform_point(mi, o),
                                    vm.transform_vector(mi, d),
                                    p[..., 0, :], p[..., 1, :], p[..., 2, :])
    valid = tri >= 0
    return Hit(t=t, tri=tri, inst=inst, a=torch.where(valid, a, zeros),
               b=torch.where(valid, b, zeros))


@torch.no_grad()
def iseg_trace(scene: Scene, o, d, time, tmin, tmax,
               any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.iclusters' segment table in plain
    PyTorch -> Hit."""
    global CALLS
    CALLS += 1
    cheap, need_ab = modes(scene, any_hit)
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, inst, a, b = trace_ids(scene.iclusters, o, d, tmin, tmax, cheap,
                                   need_ab)
    return finish(scene, o, d, time, t, tri, inst, cheap, a, b)
