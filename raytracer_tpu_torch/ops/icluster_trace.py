"""The hierarchical two-level tracer in plain PyTorch: the reference for
the CUDA kernel csrc/icluster_trace.cu.

Same inputs and outputs as the JAX package's Pallas kernel
(raytracer_tpu/ops/pallas/icluster_kernel.py:pallas_icluster_trace).
Rule, per ray:
  * visit the instances in table order (the lanes of scene.iclusters.ibb
    below num_instances) and take one whose world box entry key
    max(near, 0) beats the best t; move the ray into its object space
    with the instance's world -> object affine (rows summed as
    m0*ox + m1*oy + m2*oz + m3, icluster_kernel.py:175-180; the direction
    is not renormalised, so t is the same in both spaces);
  * visit that prototype's clusters in table order, slab-test each
    cluster box (pbb) with the object-space ray and its own clamped
    reciprocal, and Moller-Trumbore-test the 128 lanes of one whose key
    beats the best t;
  * a hit replaces the best only with a strictly smaller t: on equal t
    the first instance in table order, then the first cluster, then the
    lowest lane wins.
The Pallas kernel visits a block's instances in block-nearest order, so it
agrees with this rule on t and on hit or miss for every ray, and on tri
and inst except where two hits have exactly equal t. Reciprocal clamp,
best-t start, miss outputs, `cheap_any` and the object-space barycentric
recompute, and `need_ab` with the exact any-hit of alpha scenes, are those
of ops/iseg_trace.py. Rays in 32-ray blocks that
cannot reach the union of the instance boxes are culled first
(ops/bundle.py, icluster_kernel.py:353-359); the cull changes no hit.

Vectorised, with the CUDA kernel's cull: the instances are walked over
three levels of fan-out-8 union boxes in table order (bundle.group_levels;
cluster_trace.walk), in chunks of one 64-instance group, and each
entered prototype's clusters over two levels of its own (8 and 64
clusters, in object space). A box's key is computed only where its
groups' keys beat the best t. Instances, then (ray, instance) pairs, then
(pair, cluster) triples are swept in chunks against the best t of the
chunk's start (a superset of the sequential visit, which only adds hits
that lose; a group's key never exceeds a member's, so the cull drops
nothing the flat scan keeps).
"""
from __future__ import annotations

import torch

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from . import bundle
from . import intersect as isect
from .cluster_trace import (DEPTH, GROUP, _mt, descend, modes, rcp,
                            reduce_best, walk)
from .intersect import Hit
from .iseg_trace import finish, pool_slabs, to_object

PAIR_CHUNK = 1024
TRIPLE_CHUNK = 8192

# the prototype walk's group levels (8 and 64 clusters); the instance walk
# takes the cluster kernel's three (cluster_trace.DEPTH)
PROTO_DEPTH = 2

# number of calls of the plain version, so a run can show which path it took
CALLS = 0


def instance_levels(icl):
    """The three group levels of the instance boxes (8, 64 and 512
    instances), over the num_instances real ones."""
    return bundle.group_levels(icl.ibb[:, :icl.num_instances], GROUP, DEPTH)


def proto_levels(pbb):
    """The two group levels of every prototype's cluster boxes (8 and 64
    clusters): (P * 6, MP) -> [(P * 6, ceil(MP / 8)), (P * 6,
    ceil(MP / 64))]."""
    P = pbb.shape[0] // 6
    return [x.reshape(P * 6, -1) for x in bundle.group_levels(
        pbb.reshape(P, 6, -1), GROUP, PROTO_DEPTH)]


def trace_ids(icl, o, d, tmin, tmax, any_hit: bool, need_ab: bool = False):
    """(t, tri, inst, a, b) of the visiting rule above, for (R,) float32
    tmin, tmax; any_hit is `cheap_any`, and a, b are None unless
    need_ab."""
    R = o.shape[0]
    C = icl.tri.shape[1]
    MP = icl.pbb.shape[1]
    dev = o.device
    inv = rcp(d)
    tmax = bundle.cull_tmax(o, d, tmin, tmax, icl.ibb)
    best_t0 = torch.clamp(tmax, max=MIRO_TMAX)
    best_t = best_t0.clone()
    best_key = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_a = torch.zeros(R, device=dev) if need_ab else None
    best_b = torch.zeros(R, device=dev) if need_ab else None
    plevels = proto_levels(icl.pbb)

    def best():
        return torch.where(best_key >= 0, -torch.inf, best_t) if any_hit \
            else best_t
    for ri, ii in walk(icl.ibb[:, :icl.num_instances], instance_levels(icl),
                       o, inv, tmin, tmax, best, chunk_level=DEPTH - 1):
        for p in range(0, ri.shape[0], PAIR_CHUNK):
            r = ri[p:p + PAIR_CHUNK]
            inst = ii[p:p + PAIR_CHUNK]
            oo, dd = to_object(icl.iminv[inst], o[r], d[r])
            proto = icl.imeta[inst, 0].long()
            off = icl.pmeta[proto, 0].long()
            mlen = icl.pmeta[proto, 1].long()
            # the prototype walk of every pair: its top level linearly, then
            # down the levels to the clusters whose key beats the best t
            pr = (oo, rcp(dd), tmin[r], tmax[r], best()[r])
            n = [mlen, -(-mlen // GROUP), -(-mlen // GROUP ** 2)]
            pi = torch.arange(r.shape[0], device=dev)
            ci = torch.zeros_like(pi)
            pi, ci = descend(plevels[1], pi, ci, n[2], *pr,
                             fan=plevels[1].shape[1], tab=proto, group=True)
            pi, ci = descend(plevels[0], pi, ci, n[1], *pr, tab=proto,
                             group=True)
            pi, ci = descend(icl.pbb, pi, ci, n[0], *pr, tab=proto)
            for q in range(0, pi.shape[0], TRIPLE_CHUNK):
                pj = pi[q:q + TRIPLE_CHUNK]
                cj = ci[q:q + TRIPLE_CHUNK]
                rj = r[pj]
                p0, e1, e2, tid = pool_slabs(icl, (off[pj] + cj)[:, None])
                t, a, b, det = _mt(oo[pj, :, None], dd[pj, :, None], p0, e1,
                                   e2, tid >= 0)
                ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
                    & (det != 0.0) & (tid >= 0) \
                    & (t >= tmin[rj, None]) & (t < best_t[rj, None])
                if any_hit:
                    best_key[rj[ok.any(dim=1)]] = 0
                    continue
                order = (inst[pj] * MP + cj) * C
                best_t, best_key = reduce_best(
                    rj, t, ok, order, best_t, best_key, R,
                    (a, b, best_a, best_b) if need_ab else None)
    got = best_key >= 0
    miss_t = torch.full_like(best_t, MIRO_TMAX)
    if any_hit:
        return (torch.where(got, best_t0, miss_t),
                torch.where(got, 1, -1).to(torch.int32),
                torch.zeros(R, dtype=torch.int32, device=dev), None, None)
    k = best_key.clamp(min=0)
    inst, c, lane = k // (MP * C), (k // C) % MP, k % C
    row = icl.pmeta[icl.imeta[inst, 0].long(), 0].long() + c
    tri = torch.where(got, icl.tri[row, lane], -1).to(torch.int32)
    inst = torch.where(got, icl.imeta[inst, 1], 0).to(torch.int32)
    return torch.where(got, best_t, miss_t), tri, inst, best_a, best_b


@torch.no_grad()
def icluster_trace(scene: Scene, o, d, time, tmin, tmax,
                   any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.iclusters' instance and prototype
    tables in plain PyTorch -> Hit."""
    global CALLS
    CALLS += 1
    cheap, need_ab = modes(scene, any_hit)
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, inst, a, b = trace_ids(scene.iclusters, o, d, tmin, tmax, cheap,
                                   need_ab)
    return finish(scene, o, d, time, t, tri, inst, cheap, a, b)
