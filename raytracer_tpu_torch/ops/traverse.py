"""Wide-BVH traversal in plain PyTorch: the reference for the CUDA kernel
csrc/bvh_trace.cu.

Port of raytracer_tpu/ops/traverse.py:bvh_trace (an XLA while-loop under
vmap, not a Pallas kernel): every ray runs the same short-stack loop over
the merged node pool of geometry/bvh.py, and the loop here is vectorised
over the rays whose stack is not yet empty (one iteration pops one node of
each). Per node visit:
  * the B child boxes are slab-tested against [tmin, min(best_t, tmax)]
    with the clamped reciprocal of the direction (`ops/cluster_trace.rcp`);
    an empty slot's (+inf, -inf) box passes with near = -inf, so only its
    count (-1) leaves it out, but the box counter counts all B slots;
  * the triangle leaves are one (B * MAX_LEAF)-lane Moller-Trumbore batch
    (the corners lerped by ray time, p0 + time (q0 - p0), in a
    motion-blurred scene; object space inside an instance), cut by the
    alpha maps (alpha >= 0.5, `intersect.alpha_of`); the hit of smallest t
    replaces the ray's best, the lowest lane on equal t;
  * instance leaves push (BLAS root, instance) pairs, slot by slot;
  * internal children are pushed after them, far first: the stable order
    of -near, so among equal near the higher slot is popped first.
Any-hit rays stop at their first hit. A miss returns t = MIRO_TMAX.
Nothing here fuses a multiply with an add, so the kernel, built with
-fmad=false, matches this version bit for bit: t, tri, inst, a, b and the
counters.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import BVHArrays, Scene
from ..core.vecmath import MIRO_TMAX
from . import intersect as isect
from .cluster_trace import rcp
from .intersect import Hit

MAX_LEAF = 4  # static leaf width baked by the host build (src/Miro.h:38)

# number of calls of the plain version, so a run can show which path it took
CALLS = 0


def stack_bound(bvh: BVHArrays) -> int:
    """The traversal's worst-case stack depth (traverse.py:57)."""
    B = bvh.child.shape[1]
    return bvh.depth * (B - 1) + B * MAX_LEAF + 4


def _push_order(near, internal):
    """The slots of each row in the order the JAX package pushes its
    internal children: a stable argsort of -key with key = near for an
    internal child and -inf otherwise (a slot's rank counts the slots of
    larger key and the earlier slots of equal key; -0 equals +0) ->
    (rank of each slot, (A, B) long)."""
    key = torch.where(internal, near, -torch.inf)
    kc, kj = key[:, :, None], key[:, None, :]
    B = key.shape[1]
    earlier = torch.ones(B, B, dtype=torch.bool,
                         device=key.device).tril(-1)    # [c, j]: j < c
    return ((kj > kc) | ((kj == kc) & earlier)).sum(-1)


@torch.no_grad()
def bvh_trace(scene: Scene, o, d, time, tmin, tmax, any_hit: bool = False,
              collect_stats: bool = False):
    """Trace a wavefront against the merged BVH -> Hit, and with
    collect_stats the per-ray test counters {'ray_aabb', 'ray_tri'} (the
    reference's rayBoxIntersections / rayTriangleIntersections,
    src/BVH.h:116, src/Scene.cpp:202-216) as a second value.

    o, d: (R, 3); time, tmin, tmax: scalars or (R,). any_hit accepts the
    first hit found (shadow rays, src/BVH.cpp:1438)."""
    global CALLS
    CALLS += 1
    bvh = scene.blas
    if bvh is None:
        raise ValueError('the scene carries no BVH: build it with bvh=True')
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    R, dev = o.shape[0], o.device
    B = bvh.child.shape[1]
    S = stack_bound(bvh)
    P = bvh.prim_order.shape[0]
    two = not scene.single_level
    i32 = torch.int32
    stack_n = torch.zeros((R, S), dtype=i32, device=dev)
    stack_n[:, 0] = scene.bvh_root
    stack_i = torch.full((R, S), -1, dtype=i32, device=dev) if two else None
    sp = torch.ones(R, dtype=torch.long, device=dev)
    best_t = torch.clamp(tmax, max=MIRO_TMAX)
    best_tri = torch.full((R,), -1, dtype=i32, device=dev)
    best_inst = torch.zeros(R, dtype=i32, device=dev)
    best_a = torch.zeros(R, device=dev)
    best_b = torch.zeros(R, device=dev)
    n_box = torch.zeros(R, dtype=i32, device=dev)
    n_tri = torch.zeros(R, dtype=i32, device=dev)
    k = torch.arange(MAX_LEAF, device=dev)
    while True:
        go = sp > 0
        if any_hit:
            go &= best_tri < 0
        idx = go.nonzero().squeeze(1)
        A = idx.numel()
        if A == 0:
            break
        rows = torch.arange(A, device=dev)
        s = sp[idx] - 1
        # a read past the bound clamps, a write past it drops (as jnp's
        # gather and scatter do); the bound is never reached
        at = s.clamp(max=S - 1)
        node = stack_n[idx, at].long()
        oo, dd = o[idx], d[idx]
        if two:
            iid = stack_i[idx, at]
            inside = (iid >= 0)[:, None]
            mi = scene.instances.m_inv[iid.clamp(min=0).long()]
            oo = torch.where(inside, vm.transform_point(mi, oo), oo)
            dd = torch.where(inside, vm.transform_vector(mi, dd), dd)
        else:
            iid = torch.zeros(A, dtype=i32, device=dev)
        inv = rcp(dd)

        # ---- the B child slabs
        t0 = (bvh.node_min[node] - oo[:, None]) * inv[:, None]
        t1 = (bvh.node_max[node] - oo[:, None]) * inv[:, None]
        n, f = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = torch.maximum(torch.maximum(n[..., 0], n[..., 1]), n[..., 2])
        far = torch.minimum(torch.minimum(f[..., 0], f[..., 1]), f[..., 2])
        limit = torch.minimum(best_t[idx], tmax[idx])
        slab = (near <= far) & (far >= tmin[idx, None]) \
            & (near <= limit[:, None])
        child = bvh.child[node]
        count = bvh.count[node]

        # ---- triangle leaves: the (B * MAX_LEAF)-lane batch, tested on the
        # real lanes only
        lane = slab[..., None] & (count[..., None] > 0) \
            & (k < count[..., None])
        prim = bvh.prim_order[(child[..., None] + k).clamp(0, P - 1)]
        lane, prim = lane.reshape(A, -1), prim.reshape(A, -1)
        rj, lj = lane.nonzero(as_tuple=True)
        tri = prim[rj, lj]
        p = isect.gather_tri_verts(scene, tri, time[idx][rj])
        t, a, b, ok = isect.mt_intersect(oo[rj], dd[rj], p[:, 0], p[:, 1],
                                         p[:, 2])
        ok &= (t >= tmin[idx][rj]) & (t < limit[rj])
        if scene.has_alpha_maps:
            sel = ok.nonzero().squeeze(1)
            ok[sel] = isect.alpha_of(scene, tri[sel], a[sel], b[sel]) >= 0.5
        lane_t = torch.full(lane.shape, torch.inf, device=dev)
        lane_t[rj, lj] = torch.where(ok, t, torch.inf)
        tj, j = lane_t.min(dim=1)           # the first lane of equal t
        found = torch.isfinite(tj)
        pick = lambda x: torch.zeros(lane.shape, device=dev).index_put_(
            (rj, lj), x)[rows, j]
        best_t[idx] = torch.where(found, tj, best_t[idx])
        best_tri[idx] = torch.where(found, prim[rows, j], best_tri[idx])
        best_inst[idx] = torch.where(found, iid.clamp(min=0), best_inst[idx])
        best_a[idx] = torch.where(found, pick(a), best_a[idx])
        best_b[idx] = torch.where(found, pick(b), best_b[idx])

        # ---- the pushes, in order: instance leaves (slot, then lane),
        # then internal children far first
        nodes, insts, masks = [], [], []
        if two:
            inst_leaf = slab & (count <= -2)
            n_inst = torch.where(inst_leaf, -(count + 1), 0)
            ii = prim.reshape(A, B, MAX_LEAF)
            nodes.append(scene.instances.root[
                ii.clamp(0, scene.instances.root.shape[0] - 1).long()]
                .reshape(A, -1))
            insts.append(ii.reshape(A, -1))
            masks.append((inst_leaf[..., None] & (k < n_inst[..., None]))
                         .reshape(A, -1))
        internal = slab & (count == 0)
        rank = _push_order(near, internal)
        nodes.append(torch.empty_like(child).scatter_(1, rank, child))
        insts.append(iid[:, None].expand(A, B))
        masks.append(torch.empty_like(internal).scatter_(1, rank, internal))
        nodes, insts, masks = (torch.cat(x, 1) for x in (nodes, insts,
                                                         masks))
        pos = s[:, None] + masks.cumsum(1) - 1
        w = masks & (pos < S)
        r_w = idx[:, None].expand_as(pos)[w]
        stack_n[r_w, pos[w]] = nodes[w]
        if two:
            stack_i[r_w, pos[w]] = insts[w]
        sp[idx] = s + masks.sum(1)
        if collect_stats:
            n_box[idx] += B
            n_tri[idx] += lane.sum(1, dtype=i32)
    t = torch.where(best_tri >= 0, best_t, torch.full_like(best_t, MIRO_TMAX))
    hit = Hit(t=t, tri=best_tri, inst=best_inst, a=best_a, b=best_b)
    if collect_stats:
        return hit, dict(ray_aabb=n_box, ray_tri=n_tri)
    return hit
