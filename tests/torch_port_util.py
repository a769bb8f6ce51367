"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

They carry a JAX-package scene, camera and settings across to
raytracer_tpu_torch and back, make test rays with numpy from a seed, so
both packages see the very same inputs, and build the port's scenes on the
CPU (`cpu`; the port builds on the card by default). jax is imported only
by the helpers that need it, so tests/test_torch_cuda.py, which runs where
jax is absent, can use `cpu` too.
"""
from __future__ import annotations

import dataclasses
import operator

import numpy as np

from raytracer_tpu_torch import convert
from raytracer_tpu_torch.geometry import shapes
from raytracer_tpu_torch.io.objload import make_single_triangle


def cpu(make, *args, **kw):
    """A scene builder's result built on the CPU: make(..., device='cpu'),
    for registry builders, registry.make and SceneBuilder.build alike."""
    return make(*args, device='cpu', **kw)


def scene_arrays(scene_j):
    """(arrays, static) of a JAX scene, keyed by dotted pytree paths."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(scene_j)[0]
    arrays = {'.'.join(k.name for k in path): np.asarray(v)
              for path, v in leaves}
    static = {}
    for k in convert.STATIC_FIELDS:
        owner, _, name = k.rpartition('.')
        obj = operator.attrgetter(owner)(scene_j) if owner else scene_j
        if obj is not None:          # tables a scene does not carry
            static[k] = getattr(obj, name)
    return arrays, static


def to_port(scene_j):
    """The JAX scene as a raytracer_tpu_torch Scene (on the CPU)."""
    return cpu(convert.scene_from_arrays, *scene_arrays(scene_j))


def jax_camera(cam):
    """A port Camera as a JAX Camera."""
    import jax.numpy as jnp
    from raytracer_tpu.core import types as JT

    return JT.Camera(**{f.name: jnp.asarray(getattr(cam, f.name).numpy())
                        for f in dataclasses.fields(cam)})


def jax_settings(settings, **overrides):
    """A port RenderSettings as the JAX package's RenderSettings."""
    from raytracer_tpu.core import types as JT

    kw = dataclasses.asdict(settings)
    kw.update(overrides)
    return JT.RenderSettings(**kw)


def port_settings(settings_j, **overrides):
    """The JAX package's RenderSettings as the port's (the fields the
    port keeps)."""
    from raytracer_tpu_torch.core.types import RenderSettings

    kw = {f.name: getattr(settings_j, f.name)
          for f in dataclasses.fields(RenderSettings)}
    kw.update(overrides)
    return RenderSettings(**kw)


def port_camera(cam_j):
    """A JAX Camera as the port's, on the CPU."""
    leaves = {f: np.asarray(getattr(cam_j, f)) for f in (
        'eye', 'view_dir', 'up', 'fov', 'focus_plane', 'aperture',
        'shutter')}
    return cpu(convert.camera_from_arrays, leaves)


def random_rays(bb_min, bb_max, tri, R, seed):
    """Incoherent rays: origins scattered around the scene's box, aimed at
    random points inside it -> numpy (o, d, time, distance to that point)."""
    rs = np.random.default_rng(seed)
    real = np.asarray(tri)[:, 0] >= 0       # skip the padding rows
    lo = np.asarray(bb_min)[real].min(0)
    hi = np.asarray(bb_max)[real].max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = ctr + rs.normal(size=(R, 3)) * ext
    tgt = ctr + rs.uniform(-0.5, 0.5, (R, 3)) * ext
    d = tgt - o
    dist = np.linalg.norm(d, axis=-1)
    d /= dist[:, None]
    time = rs.uniform(size=R)
    f = lambda x: np.ascontiguousarray(x, np.float32)
    return f(o), f(d), f(time), f(dist)


def triangle_soup(T, R, seed, n_dup=64):
    """A random triangle soup with forced ties, and rays that mostly hit it
    -> numpy (o, d, p0, p1, p2, valid, tmin, tmax, dup).

    Triangles T - n_dup .. T - 1 repeat triangles 0 .. n_dup - 1 (exact
    ties, won by the lower id); every 9th triangle is a padding lane
    (valid 0). Each ray aims at a random point of a random triangle (half
    of them at a duplicated one) from 1-4 units away; every 4th ray starts
    its interval past its target (tmin = 1.5 distance), every 16th is dead
    (tmax = -1), the rest end at 3x the distance. dup marks the rays aimed
    at a duplicated triangle."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-2, 2, (T, 3))
    p0, p1, p2 = c, c + rs.normal(size=(T, 3)) * 0.5, \
        c + rs.normal(size=(T, 3)) * 0.5
    for p in (p0, p1, p2):
        p[T - n_dup:] = p[:n_dup]
    valid = np.ones(T, np.int32)
    valid[::9] = 0
    valid[T - n_dup:] = valid[:n_dup]
    dup = rs.uniform(size=R) < 0.5
    k = np.where(dup, rs.integers(0, n_dup, R), rs.integers(0, T, R))
    u, v = rs.uniform(size=R), rs.uniform(size=R)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    tgt = p0[k] + u[:, None] * (p1[k] - p0[k]) + v[:, None] * (p2[k] - p0[k])
    dirs = rs.normal(size=(R, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dist = rs.uniform(1, 4, R)
    o = tgt - dirs * dist[:, None]
    lane = np.arange(R)
    tmin = np.where(lane % 4 == 1, 1.5 * dist, 1e-3)
    tmax = np.where(lane % 16 == 3, -1.0, 3.0 * dist)
    f = lambda x: np.ascontiguousarray(x, np.float32)
    return (f(o), f(dirs), f(p0), f(p1), f(p2), valid, f(tmin), f(tmax),
            dup & (valid[k] > 0))


def _tri_fan(rs, ctr, n, spread, size):
    """n small random triangles around ctr -> float32 corners a, b, c."""
    a = (ctr + rs.uniform(-spread, spread, (n, 3))).astype(np.float32)
    b = (a + rs.normal(size=(n, 3)) * size).astype(np.float32)
    c = (a + rs.normal(size=(n, 3)) * size).astype(np.float32)
    return a, b, c


def cluster_table(M, seed, mb=False, C=128, max_lanes=12):
    """A synthetic cluster table of exactly M rows, for the walk's edge
    cases: row m holds 1-max_lanes small random triangles (every 50th row
    all C lanes), real lanes first, around the m-th point of a 16 x 16 x k
    grid walked in row order, so consecutive rows lie close together as the
    SAH build's depth-first leaves do; every 97th row is padding (no
    triangle, the never-hit box). With mb, each row's t = 1 pose is shifted
    by up to 0.3, and its box bounds both poses -> Clusters on the CPU."""
    import torch
    from raytracer_tpu_torch.geometry.clusters import NEVER, Clusters

    rs = np.random.default_rng(seed)
    basis = np.zeros((6, M, 3, C), np.float32)    # p0, e1, e2, then t = 1
    tri = np.full((M, C), -1, np.int32)
    lo = np.full((M, 3), NEVER, np.float32)
    hi = np.full((M, 3), NEVER, np.float32)
    nid = 0
    for m in range(M):
        if m % 97 == 5:
            continue
        n = C if m % 50 == 7 else int(rs.integers(1, max_lanes + 1))
        ctr = np.array([m % 16, (m // 16) % 16, m // 256]) * 1.5
        a, b, c = _tri_fan(rs, ctr, n, 0.6, 0.3)
        poses = [(a, b, c)]
        if mb:
            shift = rs.uniform(-0.3, 0.3, 3).astype(np.float32)
            poses.append((a + shift, b + shift, c + shift))
        for k, (pa, pb, pc) in enumerate(poses):
            basis[3 * k, m, :, :n] = pa.T
            basis[3 * k + 1, m, :, :n] = (pb - pa).T
            basis[3 * k + 2, m, :, :n] = (pc - pa).T
        pts = np.concatenate([x for pose in poses for x in pose])
        lo[m], hi[m] = pts.min(0), pts.max(0)
        tri[m, :n] = nid + np.arange(n)
        nid += n
    t = torch.from_numpy
    p0, e1, e2 = t(basis[0]), t(basis[1]), t(basis[2])
    q = (t(basis[3]), t(basis[4]), t(basis[5])) if mb else (p0, e1, e2)
    return Clusters(bb_min=t(lo), bb_max=t(hi), p0=p0, e1=e1, e2=e2,
                    p0_t1=q[0], e1_t1=q[1], e2_t1=q[2], tri=t(tri),
                    cluster_size=C)


def instanced_table(n_inst, proto_clusters, seed, C=128, max_lanes=8):
    """A synthetic two-level table for the hierarchical walk: prototype p
    has proto_clusters[p] clusters of 1-max_lanes small triangles (every
    37th cluster all C lanes) on a 4 x 4 x k object-space grid; n_inst
    instances, each of a random prototype turned about y, scaled by
    0.8-1.2 and placed on a 12-wide world grid, 3 apart; three padding
    lanes after them -> InstancedClusters on the CPU (the segment table
    left empty)."""
    import torch
    from raytracer_tpu_torch.geometry.clusters import (NEVER,
                                                       InstancedClusters)

    rs = np.random.default_rng(seed)
    P, MP, Mtot = len(proto_clusters), max(proto_clusters), \
        sum(proto_clusters)
    basis = np.zeros((3, Mtot * 3, C), np.float32)
    tri = np.full((Mtot, C), -1, np.int32)
    pbb = np.full((P * 6, MP), NEVER, np.float32)
    pmeta = np.zeros((P, 2), np.int32)
    pool_proto = np.zeros(Mtot, np.int32)
    pool_local = np.zeros(Mtot, np.int32)
    plo, phi = np.zeros((P, 3)), np.zeros((P, 3))
    row = nid = 0
    for p, k in enumerate(proto_clusters):
        pmeta[p] = row, k
        for c in range(k):
            n = C if c % 37 == 3 else int(rs.integers(1, max_lanes + 1))
            ctr = np.array([c % 4, (c // 4) % 4, c // 16]) * 0.5
            a, b, cc = _tri_fan(rs, ctr, n, 0.3, 0.15)
            for i, x in enumerate((a, b - a, cc - a)):
                basis[i, 3 * row:3 * row + 3, :n] = x.T
            tri[row, :n] = nid + np.arange(n)
            pts = np.concatenate([a, b, cc])
            pbb[6 * p:6 * p + 3, c] = pts.min(0)
            pbb[6 * p + 3:6 * p + 6, c] = pts.max(0)
            pool_proto[row], pool_local[row] = p, c
            row += 1
            nid += n
        real = slice(6 * p, 6 * p + 6)
        plo[p], phi[p] = pbb[real][:3, :k].min(1), pbb[real][3:, :k].max(1)
    I = n_inst + 3
    ibb = np.full((6, I), NEVER, np.float32)
    iminv = np.tile(np.eye(3, 4, dtype=np.float32).reshape(12), (I, 1))
    imeta = np.zeros((I, 2), np.int32)
    bits = (np.arange(8)[:, None] >> np.arange(3)) & 1
    for i in range(n_inst):
        p = int(rs.integers(P))
        ang, s = rs.uniform(0, 2 * np.pi), rs.uniform(0.8, 1.2)
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        tr = np.array([(i % 12) * 3.0, 0.0, (i // 12) * 3.0])
        corners = (plo[p] * (1 - bits) + phi[p] * bits) @ (s * rot).T + tr
        ibb[:3, i], ibb[3:, i] = corners.min(0), corners.max(0)
        inv = rot.T / s
        iminv[i] = np.concatenate([inv, -(inv @ tr)[:, None]], 1).reshape(12)
        imeta[i] = p, i
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return InstancedClusters(
        ibb=t(ibb), iminv=t(iminv), imeta=t(imeta), pbb=t(pbb),
        pmeta=t(pmeta), tri=t(tri), sbb=t(np.full((6, 1), NEVER, np.float32)),
        smeta=t(np.zeros((1, 3), np.int32)),
        strf=t(np.zeros((1, 12), np.float32)), pool_proto=t(pool_proto),
        pool_local=t(pool_local), p0=t(basis[0]), e1=t(basis[1]),
        e2=t(basis[2]), cluster_size=C, num_instances=n_inst, num_entries=0,
        max_proto_clusters=MP)


def box_rays(lo, hi, R, seed):
    """Rays for a box [lo, hi]: the first half from around it aimed at
    random points inside, the second from random points inside in random
    directions -> numpy float32 (o, d)."""
    rs = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    h = R // 2
    o = np.concatenate([ctr + rs.normal(size=(h, 3)) * ext,
                        lo + rs.uniform(size=(R - h, 3)) * (hi - lo)])
    d = np.concatenate([lo + rs.uniform(size=(h, 3)) * (hi - lo) - o[:h],
                        rs.normal(size=(R - h, 3))])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def grazing_rays(bb6, R, seed, parallel=True, nudge=0.0):
    """Rays that graze the faces of boxes of a (6, n) table (real boxes
    only), each through a point on an edge of a random box (two
    coordinates on face planes, or `nudge` times the box's extent off
    them, inward or outward at random), from 3 units away. parallel: the
    ray lies in those planes (zero direction components there: the
    clamped reciprocals); else it comes from a random direction, touching
    the box near the edge or crossing it -> numpy float32 (o, d)."""
    rs = np.random.default_rng(seed)
    bb = np.asarray(bb6, np.float32)
    real = np.nonzero(bb[0] < 1e37)[0]
    j = real[rs.integers(len(real), size=R)]
    lo, hi = bb[:3, j].T, bb[3:, j].T
    pt = lo + rs.uniform(size=(R, 3)).astype(np.float32) * (hi - lo)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    rows = np.arange(R)
    ax0 = rs.integers(3, size=R)
    for ax in (ax0, (ax0 + 1) % 3):
        side = rs.uniform(size=R) < 0.5
        off = nudge * (hi[rows, ax] - lo[rows, ax]) * rs.choice([-1, 1], R)
        pt[rows, ax] = np.where(side, lo[rows, ax], hi[rows, ax]) + off
        if parallel:
            d[rows, ax] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = pt - d * np.float32(3.0)
    return o.astype(np.float32), d.astype(np.float32)


def table_rays(table, R, seed):
    """Rays from 1-4 units away aimed at random points of random triangles
    of a cluster table (Clusters, its t = 0 pose) or a two-level one
    (InstancedClusters: a random instance's triangle, in world space)
    -> numpy float32 (o, d)."""
    rs = np.random.default_rng(seed)
    u, v = rs.uniform(size=(2, R, 1))
    u, v = np.where(u + v > 1, 1 - u, u), np.where(u + v > 1, 1 - v, v)
    tri = table.tri.numpy()
    if hasattr(table, 'bb_min'):                  # a single-level table
        m, lane = np.nonzero(tri >= 0)
        k = rs.integers(len(m), size=R)
        p0, e1, e2 = (x.numpy()[m[k], :, lane[k]]
                      for x in (table.p0, table.e1, table.e2))
        tgt = p0 + u * e1 + v * e2
    else:
        n = table.num_instances
        inst = rs.integers(n, size=R)
        proto = table.imeta.numpy()[inst, 0]
        off, mlen = table.pmeta.numpy()[proto].T
        row = off + rs.integers(1 << 30, size=R) % mlen
        lane = rs.integers(1 << 30, size=R) % (tri[row] >= 0).sum(1)
        p0, e1, e2 = (np.stack([x.numpy()[3 * row + c, lane]
                                for c in range(3)], -1)
                      for x in (table.p0, table.e1, table.e2))
        obj = p0 + u * e1 + v * e2
        minv = table.iminv.numpy()[inst].reshape(R, 3, 4).astype(np.float64)
        tgt = np.einsum('rij,rj->ri', np.linalg.inv(minv[:, :, :3]),
                        obj - minv[:, :, 3])
    d = rs.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = tgt - d * rs.uniform(1, 4, (R, 1))
    return o.astype(np.float32), d.astype(np.float32)


def segment_table(n_inst, proto_rows, seed, C=128, max_lanes=8):
    """A synthetic table for the segment walk: instanced_table's
    prototypes and instances, each prototype's pool rows padded with empty
    rows to a multiple of KIN, and the segment table in instance order:
    one segment per run of KIN rows, its world box the 8 corners of the
    union of the run's real cluster boxes through the instance's transform,
    its world -> object rows the instance's -> InstancedClusters on the
    CPU (pmeta counts each prototype's real rows)."""
    import torch
    from raytracer_tpu_torch.geometry.clusters import KIN, NEVER

    icl = instanced_table(n_inst, proto_rows, seed, C, max_lanes)
    tri, p0, e1, e2 = (x.numpy() for x in (icl.tri, icl.p0, icl.e1, icl.e2))
    pbb, pmeta = icl.pbb.numpy(), icl.pmeta.numpy().copy()
    pools = ([], [], [], [])                    # tri, p0, e1, e2 per row
    runs = []                                   # per prototype: (base, lo, hi)
    row = 0
    for p, k in enumerate(proto_rows):
        off = int(pmeta[p, 0])
        padded = -(-k // KIN) * KIN
        pmeta[p, 0] = row
        for r in range(padded):
            real = r < k
            pools[0].append(tri[off + r] if real else np.full(C, -1, np.int32))
            for pool, x in zip(pools[1:], (p0, e1, e2)):
                pool.append(x[3 * (off + r):3 * (off + r) + 3] if real
                            else np.zeros((3, C), np.float32))
        box = pbb[6 * p:6 * p + 6]
        runs.append([(row + s, box[:3, s:min(s + KIN, k)].min(1),
                      box[3:, s:min(s + KIN, k)].max(1))
                     for s in range(0, k, KIN)])
        row += padded
    bits = (np.arange(8)[:, None] >> np.arange(3)) & 1
    sbb, smeta, strf = [], [], []
    iminv = icl.iminv.numpy()
    for i in range(n_inst):
        minv = iminv[i].reshape(3, 4).astype(np.float64)
        m = np.linalg.inv(minv[:, :3])
        for base, lo, hi in runs[int(icl.imeta[i, 0])]:
            w = (lo * (1 - bits) + hi * bits) @ m.T - m @ minv[:, 3]
            sbb.append(np.concatenate([w.min(0), w.max(0)]))
            smeta.append((i, base, i))
            strf.append(iminv[i])
    E = len(sbb) + 3                            # three padding lanes
    sbb = np.concatenate([np.asarray(sbb, np.float32).T,
                          np.full((6, 3), NEVER, np.float32)], 1)
    smeta = np.concatenate([np.asarray(smeta, np.int32),
                            np.zeros((3, 3), np.int32)])
    strf = np.concatenate([np.asarray(strf, np.float32),
                           np.tile(np.eye(3, 4, dtype=np.float32).reshape(12),
                                   (3, 1))])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    stack = lambda xs: t(np.concatenate(xs) if xs[0].ndim == 2
                         else np.stack(xs))
    return dataclasses.replace(
        icl, tri=stack(pools[0]), p0=stack(pools[1]), e1=stack(pools[2]),
        e2=stack(pools[3]), pmeta=t(pmeta), sbb=t(sbb), smeta=t(smeta),
        strf=t(strf), num_entries=E - 3,
        pool_proto=torch.zeros(row, dtype=torch.int32),
        pool_local=torch.zeros(row, dtype=torch.int32))


def mt_hit_key(t, tri):
    """The merge key of the MT kernel's split grid (csrc/mt_trace.cu
    hit_key), modelled on the CPU, of hits (t, tri) -> int64 in the
    kernel's unsigned order: t's order-preserving bits, -0 counted as +0,
    then the triangle id."""
    import torch

    u = torch.where(t == 0, 0.0, t).view(torch.int32).long() & 0xFFFFFFFF
    k = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)
    return (k - (1 << 31)) * (1 << 32) + tri.long()


def mt_split_trace(o, d, p0, p1, p2, valid, tmin, tmax, per_split):
    """ops/mt_trace.mt_trace as the MT kernel's split grid computes it,
    modelled on the CPU: each range of per_split triangles swept alone,
    each ray's winner the smallest mt_hit_key over the ranges, its t, a
    and b recomputed by _mt_block -> (t, tri, a, b)."""
    import torch
    from raytracer_tpu_torch.ops import mt_trace as tmt

    R, T = o.shape[0], p0.shape[0]
    none = torch.iinfo(torch.int64).max
    best = torch.full((R,), none, dtype=torch.int64)
    for s in range(0, T, per_split):
        sl = slice(s, s + per_split)
        t, tri, _, _ = tmt.mt_trace(o, d, p0[sl], p1[sl], p2[sl], valid[sl],
                                    tmin, tmax)
        best = torch.minimum(best, torch.where(
            tri >= 0, mt_hit_key(t, tri + s), none))
    got = best < none
    j = torch.where(got, best & 0xFFFFFFFF, 0)
    comps = [tuple(p[j, k, None].float() for k in range(3))
             for p in (p0, p1, p2)]
    col = lambda x: tuple(x[:, k:k + 1].float() for k in range(3))
    t, a, b, _ = tmt._mt_block(col(o), col(d), *comps,
                               tmt.per_ray(tmin, o)[:, None],
                               tmt.per_ray(tmt.BIG, o)[:, None])
    return (torch.where(got, t[:, 0], tmt.MIRO_TMAX),
            torch.where(got, j, -1).to(torch.int32),
            torch.where(got, a[:, 0], 0.0), torch.where(got, b[:, 0], 0.0))


def edge_sample_parity(got, want, verts):
    """Two devices' samples of one edge term (diff/edges.EdgeSamples, the
    same key and adjoint) -> (the number of samples left out, the number
    of nonzero samples kept, the largest excess over rtol 1e-3 and atol
    1e-4 x max|grad| of the gradient summed from those kept). The same
    edges and positions must be sampled. Left out: the samples whose side
    radiance took another path on `got`'s device (a radiance more than
    1e-6 + 1e-4 |f| apart: the CPU and CUDA libraries' sin/cos and rsqrt
    differ in the last ulp, which turns a path, and the wavefront sort
    then hands the other rays of its wavefront other random numbers) and
    those accepted on one device only (a knife-edge silhouette or
    visibility test)."""
    import torch
    from raytracer_tpu_torch.diff.edges import EdgeSamples

    got = EdgeSamples(*(getattr(got, f.name).cpu()
                        for f in dataclasses.fields(got)))
    assert torch.equal(got.es, want.es) and torch.equal(got.ss, want.ss)
    off = lambda x, y: ((x - y).abs() > 1e-6 + 1e-4 * y.abs()).any(-1)
    out = off(got.f_plus, want.f_plus) | off(got.f_minus, want.f_minus) \
        | ((got.scal == 0) != (want.scal == 0))
    g = dataclasses.replace(got, scal=torch.where(out, 0.0, got.scal))
    w = dataclasses.replace(want, scal=torch.where(out, 0.0, want.scal))
    g, w = g.grad(verts), w.grad(verts)
    atol = 1e-4 * float(w.abs().max())
    return (int(out.sum()), int(((want.scal != 0) & ~out).sum()),
            float(((g - w).abs() - (atol + 1e-3 * w.abs())).max()))


def tie_scene(b):
    """Fill the SceneBuilder `b` with duplicated triangles: 6 copies of one
    (split over two BVH leaves by the median split of equal centroids) and
    3 of another, beside a small mesh of distinct ones: exact ties in t
    within a leaf and across leaves."""
    mat = b.add_lambert()
    a = make_single_triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0))
    c = make_single_triangle((2, -1, 0.5), (3, -1, 0.5), (2.5, 1, 0.5))
    for _ in range(6):
        b.add_mesh(a, mat)
    b.add_mesh(shapes.uv_sphere((-2.5, 0, 1), 0.6, 4, 8, with_uv=False), mat)
    for _ in range(3):
        b.add_mesh(c, mat)
    return b


def filled_scene(fill, builder=None, bvh=True, device='cpu'):
    """(scene, None, None) of the builder that `fill` fills: `builder` (the
    JAX package's) builds as it builds, else a new port SceneBuilder on
    `device`; the registry builders' return shape."""
    if builder is not None:
        return fill(builder).build(bvh=bvh), None, None
    from raytracer_tpu_torch import SceneBuilder
    return fill(SceneBuilder()).build(bvh=bvh, device=device), None, None


def scene_rays(scene, R, seed):
    """R rays from around the scene's vertex box to random points in it,
    each with a time in [0, 1) and a distance of 0.3-1.3 times its target's
    -> numpy (o, d, time, dist)."""
    rs = np.random.default_rng(seed)
    v = scene.geom.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = ctr + rs.normal(size=(R, 3)) * ext
    tgt = lo + rs.uniform(size=(R, 3)) * (hi - lo)
    d = tgt - o
    dist = np.linalg.norm(d, axis=-1)
    d /= dist[:, None]
    f = lambda x: np.ascontiguousarray(x, np.float32)
    return (f(o), f(d), f(rs.uniform(size=R)),
            f(dist * rs.uniform(0.3, 1.3, R)))


def ray_bounds(dist, any_hit):
    """(tmin, tmax) of the BVH tests: every 4th ray starts at half its
    distance, every 16th is dead (tmax -1); any-hit rays stop at their
    distance, nearest ones at 1e12."""
    lane = np.arange(len(dist))
    tmin = np.where(lane % 4 == 1, 0.5 * dist, 1e-3).astype(np.float32)
    tmax = np.where(lane % 16 == 3, -1.0,
                    dist if any_hit else 1e12).astype(np.float32)
    return tmin, tmax
