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
  * any-hit mode in a scene without alpha maps is the kernel's
    `cheap_any`: tri = 1 and t = min(tmax, MIRO_TMAX) for a hit
    (cluster_kernel.py:215-220);
  * in a scene with alpha maps every trace is `need_ab`: the tracer returns
    the winning lane's own a and b (cluster_kernel.py:233-238), which the
    alpha march reads; otherwise a and b are recomputed from the winning
    triangle's vertices, as the JAX wrapper does (cluster_kernel.py:451-461);
  * any-hit in a scene with alpha maps is exact: it returns the nearest hit
    with its t, a and b. The Pallas kernel returns the minimum of the first
    16-cluster batch that holds a hit for the ray, which depends on the 32
    rays that share its block; the nearest hit is the per-ray rule that
    keeps the alpha march exact;
  * `mb` lerps the stored basis per component by the ray's time,
    p + time (q - p) with q the t = 1 table (cluster_kernel.py:179-187).
This is not the JAX package's XLA `ops/cluster_trace.cluster_trace`, which
visits in near-t order and can break ties differently.

`alpha_aware_trace` is the JAX package's alpha march
(raytracer_tpu/ops/cluster_trace.py:158-257) around any of the tracers.

Vectorised over rays, with the CUDA kernel's cull: the cluster kernel's
group walk (`walk`) over three levels of fan-out-8 union boxes in table
order (bundle.group_levels), the top level scanned linearly. The clusters
are swept in chunks of one 64-cluster group; a cluster's key is computed
only where its groups' keys beat the best t at the chunk's start, and each
chunk's (ray, cluster) pairs whose box passes are Moller-Trumbore-tested
together. Testing a whole chunk against the best t of its start tests a
superset of the sequential visit, which only adds hits that lose to the
best; a union box's key never exceeds a member's, so the cull drops no
pair that the flat scan keeps.
"""
from __future__ import annotations

import torch

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from . import bundle
from . import intersect as isect
from .intersect import Hit

TINY = 1e-20
PAIR_CHUNK = 1 << 14
# the group walk of the cluster kernel and the hierarchical one: fan-out 8
# over table order, three levels (8, 64 and 512 clusters or instances)
GROUP = 8
DEPTH = 3

# number of calls of the plain version, so a run can show which path it took
CALLS = 0
# alpha-march passes traced (each one tracer call) and host syncs taken
MARCH_PASSES = 0
MARCH_SYNCS = 0
# with COUNT_TESTS set, the (ray, box) slab tests (group boxes included)
# and (ray, triangle-lane) Moller-Trumbore tests that the plain tracers
# (this one, the segment and the hierarchical one) perform in their group
# walks, summed into TESTS['box'] and TESTS['tri']: the work counts of a
# trace's least time on the card
COUNT_TESTS = False
TESTS = {'box': 0, 'tri': 0}


def modes(scene: Scene, any_hit: bool) -> tuple[bool, bool]:
    """(cheap_any, need_ab) of a trace (cluster_kernel.py:329-334): alpha
    scenes return barycentrics and trace any-hit rays as nearest ones."""
    return bool(any_hit) and not scene.has_alpha_maps, scene.has_alpha_maps


def rcp(v):
    """The Pallas kernel's clamped reciprocal."""
    tiny = torch.where(v < 0, -TINY, TINY).to(v.dtype)
    return 1.0 / torch.where(v.abs() < TINY, tiny, v)


def _mt(o, d, p0, e1, e2, real=None):
    """The kernel's Moller-Trumbore on the stored basis; o, d (P, 3, 1),
    p0/e1/e2 (P, 3, C) -> t, a, b, det of shape (P, C). `real` (P, C)
    marks the real lanes, which the test counters count (the kernels test
    no padding lane); all lanes count when it is None."""
    if COUNT_TESTS:
        TESTS['tri'] += p0.shape[0] * p0.shape[2] if real is None \
            else int(real.sum())
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


def slab_keys(lo, hi, o, inv, tmin, tmax, valid=None):
    """Entry keys of (R,) rays against boxes lo, hi of shape (1 or R, n, 3)
    -> (R, n); +inf where the slab test fails (the Pallas kernels'
    slab6), and where `valid` (R, n), if given, is False (no test)."""
    if COUNT_TESTS:
        TESTS['box'] += o.shape[0] * lo.shape[1] if valid is None \
            else int(valid.sum())
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    n, f = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(n[..., 0], n[..., 1]), n[..., 2])
    far = torch.minimum(torch.minimum(f[..., 0], f[..., 1]), f[..., 2])
    ok = (near <= far) & (far >= tmin[:, None]) & (near <= tmax[:, None])
    if valid is not None:
        ok &= valid
    return torch.where(ok, torch.clamp(near, min=0.0), torch.inf)


def descend(bb, ctx, g, n, o, inv, tmin, tmax, best_t, fan: int = GROUP,
            tab=None, group: bool = False):
    """One level down a group walk. Contexts ctx (P,) (rows of the
    per-context o, inv (.., 3), tmin, tmax, best_t, n and tab) stand at
    groups g (P,) of the level above the (6 K, L) box table bb; each is
    keyed against the `fan` members of its group below n (an int, or a
    tensor per context) in table 0, or table tab (per context) -> (ctx,
    member) of the members whose key beats best_t, context-major and in
    table order. Where bb is a group level (`group`) of a single group
    (n == 1), that group is entered untested, as the kernels do."""
    m = g[:, None] * fan + torch.arange(fan, device=g.device)
    nc = n if isinstance(n, int) else n[ctx, None]
    valid = m < nc
    test = valid & (nc > 1) if group else valid
    m = torch.where(valid, m, 0)
    rows = torch.arange(6, device=g.device)
    if tab is not None:
        rows = 6 * tab[ctx, None] + rows                      # (P, 6)
    box = bb[rows[..., None], m[:, None, :]].transpose(1, 2)  # (P, fan, 6)
    key = slab_keys(box[..., :3], box[..., 3:], o[ctx], inv[ctx], tmin[ctx],
                    tmax[ctx], test)
    p, j = torch.where(test, key < best_t[ctx, None], valid).nonzero(
        as_tuple=True)
    return ctx[p], m[p, j]


def walk(bb, levels, o, inv, tmin, tmax, best, fan: int = GROUP,
         chunk_level: int | None = None):
    """The kernels' group walk over one (6, L) box table with its group
    levels [1 .. D] (bundle.group_levels), vectorised over rays: the top
    level is scanned linearly; per chunk (one group of `chunk_level`, D or
    D - 1) yields the (ray, member) pairs, ray-major and in table order,
    of the members whose key beats the best t at the chunk's start,
    keying a member only where its groups' keys beat it too; a level of a
    single group is entered untested. `best()` -> the (R,) best t, -inf
    for a ray that walks no more. The pairs are those of the flat scan, as
    no group key exceeds a member's."""
    L = [bb] + list(levels)
    D = len(levels)
    cl = D if chunk_level is None else chunk_level
    R = o.shape[0]

    def keys(lv, j, r):
        if L[lv].shape[1] == 1:        # a single group: entered untested
            return torch.zeros(r.shape, device=o.device)
        box = L[lv][:, j]
        return slab_keys(box[None, None, :3], box[None, None, 3:], o[r],
                         inv[r], tmin[r], tmax[r])[:, 0]

    for top in range(L[D].shape[1]):
        bt = best()
        r = (bt > 0).nonzero()[:, 0]
        k_top = torch.full((R,), torch.inf, device=o.device)
        k_top[r] = keys(D, top, r)
        chunks = [top] if cl == D else \
            range(top * fan, min(L[D - 1].shape[1], (top + 1) * fan))
        for j in chunks:
            bt = best()
            r = (k_top < bt).nonzero()[:, 0]
            if cl < D:
                r = r[keys(cl, j, r) < bt[r]]
            g = torch.full_like(r, j)
            for lv in range(cl - 1, -1, -1):
                r, g = descend(L[lv], r, g, L[lv].shape[1], o, inv, tmin,
                               tmax, bt, fan, group=lv > 0)
            yield r, g


def reduce_best(r, t, ok, order, best_t, best_key, R, ab=None):
    """Fold one batch of (pair, lane) hits into the per-ray best: nearest
    t, and on equal t the lowest `order` (pair-major, lanes inside).
    ab = (a, b, best_a, best_b) also carries the winning lane's a and b
    (best_a and best_b are updated in place)."""
    tp, lane = torch.where(ok, t, torch.inf).min(dim=1)
    tr = torch.full((R,), torch.inf, device=t.device)
    tr.scatter_reduce_(0, r, tp, 'amin')
    win = torch.isfinite(tp) & (tp == tr[r])
    key = torch.full((R,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=t.device)
    key.scatter_reduce_(0, r[win], (order + lane)[win], 'amin')
    better = tr < best_t
    if ab is not None:
        a, b, best_a, best_b = ab
        won = (win & better[r] & (order + lane == key[r])).nonzero()[:, 0]
        best_a[r[won]] = a[won, lane[won]]
        best_b[r[won]] = b[won, lane[won]]
    return torch.where(better, tr, best_t), torch.where(better, key, best_key)


def lerp_basis(cl, c, w):
    """The (P, 3, C) basis p0, e1, e2 of clusters c, lerped to per-pair
    times w (P,) as p + w (q - p); the stored t = 0 basis when w is None."""
    out = []
    for x, x1 in ((cl.p0, cl.p0_t1), (cl.e1, cl.e1_t1), (cl.e2, cl.e2_t1)):
        x = x[c]
        if w is not None:
            x = x + w[:, None, None] * (x1[c] - x)
        out.append(x)
    return out


def box_levels(cl) -> list:
    """[the (6, M) cluster boxes, then their DEPTH group levels of GROUP
    members each]."""
    bb = torch.cat([cl.bb_min.T, cl.bb_max.T]).contiguous()
    return [bb] + bundle.group_levels(bb, GROUP, DEPTH)


def trace_ids(cl, o, d, tmin, tmax, any_hit: bool, time=None,
              need_ab: bool = False):
    """(t, tri, a, b) of the visiting rule above, for (R,) float32 tmin
    and tmax; any_hit is `cheap_any`; a (R,) `time` selects `mb`; a, b
    are None unless need_ab."""
    R = o.shape[0]
    M, _, C = cl.p0.shape
    dev = o.device
    inv = rcp(d)
    best_t0 = torch.clamp(tmax, max=MIRO_TMAX)
    best_t = best_t0.clone()
    best_idx = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_a = torch.zeros(R, device=dev) if need_ab else None
    best_b = torch.zeros(R, device=dev) if need_ab else None
    tri_flat = cl.tri.reshape(-1)
    bb, *levels = box_levels(cl)

    def best():
        return torch.where(best_idx >= 0, -torch.inf, best_t) if any_hit \
            else best_t
    for ri, ci in walk(bb, levels, o, inv, tmin, tmax, best, GROUP,
                       DEPTH - 1):
        for s in range(0, ri.shape[0], PAIR_CHUNK):
            r = ri[s:s + PAIR_CHUNK]
            c = ci[s:s + PAIR_CHUNK]
            p0, e1, e2 = lerp_basis(cl, c, None if time is None else time[r])
            real = cl.tri[c] >= 0
            t, a, b, det = _mt(o[r, :, None], d[r, :, None], p0, e1, e2,
                               real)
            ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
                & (det != 0.0) & real \
                & (t >= tmin[r, None]) & (t < best_t[r, None])
            if any_hit:
                best_idx[r[ok.any(dim=1)]] = 0
                continue
            best_t, best_idx = reduce_best(
                r, t, ok, c * C, best_t, best_idx, R,
                (a, b, best_a, best_b) if need_ab else None)
    got = best_idx >= 0
    tmax_t = torch.full_like(best_t, MIRO_TMAX)
    if any_hit:
        tri = torch.where(got, 1, -1).to(torch.int32)
        return torch.where(got, best_t0, tmax_t), tri, None, None
    tri = torch.where(got, tri_flat[best_idx.clamp(min=0)], -1)
    return (torch.where(got, best_t, tmax_t), tri.to(torch.int32), best_a,
            best_b)


def finish(scene: Scene, o, d, time, t, tri, any_hit: bool, a=None,
           b=None) -> Hit:
    """Hit from the traced (t, tri): the tracer's own a and b when it
    returned them (need_ab), else in nearest mode the barycentrics
    recomputed from the winning triangle, as the JAX wrapper does."""
    zeros = torch.zeros_like(t)
    if a is not None:
        return Hit(t=t, tri=tri, inst=torch.zeros_like(tri), a=a, b=b)
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
                  any_hit: bool = False, table=None, mb=None) -> Hit:
    """Trace a wavefront through scene.clusters (or `table`, such as the
    motion-blurred partition scene.mb_clusters) in plain PyTorch -> Hit;
    mb defaults to the scene's motion-blur flag."""
    global CALLS
    CALLS += 1
    cl = scene.clusters if table is None else table
    mb = scene.has_motion_blur if mb is None else mb
    cheap, need_ab = modes(scene, any_hit)
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    t, tri, a, b = trace_ids(cl, o, d, tmin, tmax, cheap,
                             time if mb else None, need_ab)
    return finish(scene, o, d, time, t, tri, cheap, a, b)


def merge_hits(h1: Hit, h2: Hit) -> Hit:
    """Nearest of two hits; h2 wins only on a strictly smaller t
    (raytracer_tpu/render/integrator.py:242-249)."""
    take2 = h2.valid & (~h1.valid | (h2.t < h1.t))
    return Hit(*(torch.where(take2, getattr(h2, f), getattr(h1, f))
                 for f in ('t', 'tri', 'inst', 'a', 'b')))


def alpha_aware_trace(scene: Scene, trace_once, o, d, time, tmin, tmax,
                      any_hit: bool = False, max_passes: int = 12) -> Hit:
    """Alpha cutouts around a tracer that does not test them: re-trace
    past each hit with alpha < 0.5 from an advanced per-ray tmin, until
    every ray has an opaque hit or a miss (src/BVH.cpp:1401-1435).

    The JAX package's march, pass for pass: pass 0 traces every ray; pass
    p traces the first max(4096, R >> (p + 1)) rows (rounded up to 256) of
    a stable live-first partition, and live rays past that budget wait.
    Rays still live after max_passes keep their last cutout hit. The
    JAX package skips a pass once every ray is settled (lax.cond); here
    that test is a host sync, and the march stops there, since no later
    pass could run either. trace_once(o, d, time, tmin, tmax, any_hit)
    -> Hit takes per-ray tmin."""
    global MARCH_PASSES, MARCH_SYNCS
    R = o.shape[0]
    time, tmin0, tmax_b = isect.ray_inputs(o, time, tmin, tmax)
    dev = o.device
    # the march state, updated in place
    s = dict(tmin=tmin0.clone(),
             done=torch.zeros(R, dtype=torch.bool, device=dev),
             t=torch.full((R,), MIRO_TMAX, device=dev),
             tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
             inst=torch.zeros(R, dtype=torch.int32, device=dev),
             a=torch.zeros(R, device=dev), b=torch.zeros(R, device=dev))

    def update(hit, sel):
        """Fold one pass's hits into rows `sel` (all rows when None)."""
        read = (lambda x: x) if sel is None else (lambda x: x[sel])
        live = ~read(s['done'])
        valid = hit.valid
        alpha = isect.alpha_of(scene, hit.tri.clamp(min=0), hit.a, hit.b)
        opaque = valid & (alpha >= 0.5)
        accept = live & opaque
        cutout = live & valid & ~opaque
        miss = live & ~valid
        # a cutout hit stands in for the opaque one if the passes run out;
        # a later miss clears it (the ray leaves through the hole)
        take = accept | cutout
        new = dict(
            t=torch.where(miss, MIRO_TMAX,
                          torch.where(take, hit.t, read(s['t']))),
            tri=torch.where(miss, -1, torch.where(take, hit.tri,
                                                  read(s['tri']))),
            inst=torch.where(take, hit.inst, read(s['inst'])),
            a=torch.where(take, hit.a, read(s['a'])),
            b=torch.where(take, hit.b, read(s['b'])),
            # advance past the cutout (relative and absolute epsilon)
            tmin=torch.where(cutout, hit.t * (1.0 + 1e-4) + 1e-4,
                             read(s['tmin'])),
            done=read(s['done']) | accept | miss)
        for k, v in new.items():
            if sel is None:
                s[k] = v.to(s[k].dtype)
            else:
                s[k][sel] = v.to(s[k].dtype)

    update(trace_once(o, d, time, s['tmin'], tmax_b, any_hit), None)
    MARCH_PASSES += 1
    for p in range(1, max_passes):
        MARCH_SYNCS += 1
        if not bool((~s['done']).any()):
            break
        Rp = min(R, max(4096, R >> (p + 1)))
        Rp = -(-Rp // 256) * 256 if Rp < R else R
        sel = torch.argsort(s['done'].to(torch.int32), stable=True)[:Rp]
        tmax_eff = torch.where(s['done'][sel], -1.0, tmax_b[sel])
        update(trace_once(o[sel], d[sel], time[sel], s['tmin'][sel],
                          tmax_eff, any_hit), sel)
        MARCH_PASSES += 1
    return Hit(t=s['t'], tri=s['tri'], inst=s['inst'], a=s['a'], b=s['b'])
