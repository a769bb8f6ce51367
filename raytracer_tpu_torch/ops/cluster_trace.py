"""The cluster tracer in plain PyTorch: the reference for the CUDA kernel.

Same inputs and outputs as the JAX package's Pallas kernel
(raytracer_tpu/ops/pallas/cluster_kernel.py:pallas_cluster_trace) and the
same visiting rule, so the two agree hit for hit:
  * each ray visits the clusters in table order and tests a cluster when
    its box entry key max(near, 0) beats the ray's best t; a hit replaces
    the best only with a strictly smaller t, so the first cluster in table
    order and the lowest lane inside it win ties;
  * direction reciprocals use the kernel's clamp |v| >= 1e-20
    (cluster_kernel.py:102-105); the best t starts at min(tmax, MIRO_TMAX);
    a miss returns t = MIRO_TMAX, tri = -1;
  * any-hit mode is the kernel's `cheap_any`: tri = 1 and t = min(tmax,
    MIRO_TMAX) for a hit (cluster_kernel.py:215-220);
  * in nearest mode a and b are recomputed from the winning triangle's
    vertices, as the JAX wrapper does (cluster_kernel.py:451-461).
This is not the JAX package's XLA `ops/cluster_trace.cluster_trace`, which
visits in near-t order and can break ties differently.

Vectorised over rays; the clusters are swept in chunks, and each chunk's
(ray, cluster) pairs whose box passes are Moller-Trumbore-tested together.
Testing a whole chunk against the best t of its start tests a superset of
the sequential visit, which only adds hits that lose to the best.
"""
from __future__ import annotations

import torch

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from . import intersect as isect
from .intersect import Hit

TINY = 1e-20
CLUSTER_CHUNK = 64
PAIR_CHUNK = 1 << 14

# number of calls of the plain version, so a run can show which path it took
CALLS = 0


def rcp(v):
    """The Pallas kernel's clamped reciprocal."""
    tiny = torch.where(v < 0, -TINY, TINY).to(v.dtype)
    return 1.0 / torch.where(v.abs() < TINY, tiny, v)


def _mt(o, d, p0, e1, e2):
    """The kernel's Moller-Trumbore on the stored basis; o, d (P, 3, 1),
    p0/e1/e2 (P, 3, C) -> t, a, b, det of shape (P, C)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / det
    tvx = ox - p0[:, 0]
    tvy = oy - p0[:, 1]
    tvz = oz - p0[:, 2]
    a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, a, b, det


def slab_keys(lo, hi, o, inv, tmin, tmax):
    """Entry keys of (R,) rays against boxes lo, hi of shape (1 or R, n, 3)
    -> (R, n); +inf where the slab test fails (the Pallas kernels'
    slab6)."""
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    n, f = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(n[..., 0], n[..., 1]), n[..., 2])
    far = torch.minimum(torch.minimum(f[..., 0], f[..., 1]), f[..., 2])
    ok = (near <= far) & (far >= tmin[:, None]) & (near <= tmax[:, None])
    return torch.where(ok, torch.clamp(near, min=0.0), torch.inf)


def reduce_best(r, t, ok, order, best_t, best_key, R):
    """Fold one batch of (pair, lane) hits into the per-ray best: nearest
    t, and on equal t the lowest `order` (pair-major, lanes inside)."""
    tp, lane = torch.where(ok, t, torch.inf).min(dim=1)
    tr = torch.full((R,), torch.inf, device=t.device)
    tr.scatter_reduce_(0, r, tp, 'amin')
    win = torch.isfinite(tp) & (tp == tr[r])
    key = torch.full((R,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=t.device)
    key.scatter_reduce_(0, r[win], (order + lane)[win], 'amin')
    better = tr < best_t
    return torch.where(better, tr, best_t), torch.where(better, key, best_key)


def trace_ids(cl, o, d, tmin, tmax, any_hit: bool):
    """(t, tri) of the visiting rule above, for (R,) float32 tmin/tmax."""
    R = o.shape[0]
    M, _, C = cl.p0.shape
    dev = o.device
    inv = rcp(d)
    best_t0 = torch.clamp(tmax, max=MIRO_TMAX)
    best_t = best_t0.clone()
    best_idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    tri_flat = cl.tri.reshape(-1)
    for c0 in range(0, M, CLUSTER_CHUNK):
        c1 = min(c0 + CLUSTER_CHUNK, M)
        key = slab_keys(cl.bb_min[None, c0:c1], cl.bb_max[None, c0:c1], o,
                        inv, tmin, tmax)
        viable = key < best_t[:, None]
        if any_hit:
            viable &= (best_idx < 0)[:, None]
        ri, ci = viable.nonzero(as_tuple=True)     # ray-major, table order
        for s in range(0, ri.shape[0], PAIR_CHUNK):
            r = ri[s:s + PAIR_CHUNK]
            c = ci[s:s + PAIR_CHUNK] + c0
            t, a, b, det = _mt(o[r, :, None], d[r, :, None], cl.p0[c],
                               cl.e1[c], cl.e2[c])
            ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
                & (det != 0.0) & (cl.tri[c] >= 0) \
                & (t >= tmin[r, None]) & (t < best_t[r, None])
            if any_hit:
                best_idx[r[ok.any(dim=1)]] = 0
                continue
            best_t, best_idx = reduce_best(r, t, ok, c * C, best_t,
                                           best_idx, R)
    got = best_idx >= 0
    tmax_t = torch.full_like(best_t, MIRO_TMAX)
    if any_hit:
        tri = torch.where(got, 1, -1).to(torch.int32)
        return torch.where(got, best_t0, tmax_t), tri
    tri = torch.where(got, tri_flat[best_idx.clamp(min=0)], -1)
    return torch.where(got, best_t, tmax_t), tri.to(torch.int32)


def finish(scene: Scene, o, d, time, t, tri, any_hit: bool) -> Hit:
    """Hit from the traced (t, tri): in nearest mode the barycentrics are
    recomputed from the winning triangle, as the JAX wrapper does."""
    zeros = torch.zeros_like(t)
    if any_hit:
        return Hit(t=t, tri=tri, inst=torch.zeros_like(tri), a=zeros,
                   b=zeros)
    p = isect.gather_tri_verts(scene, tri.clamp(min=0), time)
    _, a, b, _ = isect.mt_intersect(o, d, p[..., 0, :], p[..., 1, :],
                                    p[..., 2, :])
    valid = tri >= 0
    return Hit(t=t, tri=tri, inst=torch.zeros_like(tri),
               a=torch.where(valid, a, zeros), b=torch.where(valid, b, zeros))


@torch.no_grad()
def cluster_trace(scene: Scene, o, d, time, tmin, tmax,
                  any_hit: bool = False) -> Hit:
    """Trace a wavefront through scene.clusters in plain PyTorch -> Hit."""
    global CALLS
    CALLS += 1
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri = trace_ids(scene.clusters, o, d, tmin, tmax, any_hit)
    return finish(scene, o, d, time, t, tri, any_hit)
