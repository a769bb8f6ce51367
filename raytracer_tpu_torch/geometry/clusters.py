"""Flat and two-level triangle clusters for the cluster tracers (host side).

Port of `Clusters`, `build_clusters`, `InstancedClusters` and
`build_instanced_clusters` in raytracer_tpu/geometry/clusters.py, through
the same native binned-SAH build and the same numpy, so every table is
byte-identical to the JAX package's. The SAH build is cut into M clusters of <= C triangles;
each cluster stores its AABB and its triangles' Moller-Trumbore basis
(p0, p1 - p0, p2 - p0) as SoA (M, 3, C). Padding lanes hold degenerate
triangles with id -1 and always trail the real lanes of a cluster; padding
rows hold far-away point boxes (lo == hi == 3e37) that fail every slab test.

A table over motion-blurred triangles also stores the t = 1 pose basis
(`*_t1`); its boxes bound both poses, and the tracers lerp the basis by ray
time. A static table's `*_t1` are its t = 0 tensors themselves (one
buffer, as in the JAX build).

`refresh_clusters` and `refresh_iclusters` re-derive the tables from the
current vertices on their device (the trainer's per-step refresh,
parallel/sharding.apply_params), as the JAX package's functions of the
same names do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import Geometry, Instances, TensorData
from .. import native

NEVER = np.float32(3e37)
# prototype clusters per segment of the flat two-level table: each
# (instance, run of KIN clusters) pair is one segment with its own world
# box; prototype tables are padded to KIN rows so no run straddles two
KIN = 4


@dataclass
class Clusters(TensorData):
    """Padded SoA cluster table, M clusters x C triangles."""
    bb_min: torch.Tensor     # (M, 3) f32, union of both motion poses
    bb_max: torch.Tensor     # (M, 3) f32
    p0: torch.Tensor         # (M, 3, C) f32 [component, lane]
    e1: torch.Tensor         # (M, 3, C)
    e2: torch.Tensor         # (M, 3, C)
    p0_t1: torch.Tensor      # (M, 3, C) t = 1 pose; p0 itself when static
    e1_t1: torch.Tensor
    e2_t1: torch.Tensor
    tri: torch.Tensor        # (M, C) i32, -1 = padding
    cluster_size: int = 128

    @property
    def num_clusters(self) -> int:
        return self.tri.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes of the distinct tensors (aliased t = 1 tables count once)."""
        seen = {id(x): x for x in
                (self.bb_min, self.bb_max, self.p0, self.e1, self.e2,
                 self.p0_t1, self.e1_t1, self.e2_t1, self.tri)}
        return sum(x.numel() * x.element_size() for x in seen.values())


def build_clusters(geom: Geometry, cluster_size: int = 128,
                   pad_clusters_to: int = 8,
                   tri_ids: np.ndarray | None = None) -> Clusters:
    """Cut the SAH tree over a geometry's triangles (all of them, or the
    subset `tri_ids`) into <= cluster_size clusters; pad the row count to a
    multiple of pad_clusters_to. The tri table holds global triangle ids;
    the t = 1 pose tables are built when a triangle of the subset is
    motion-blurred."""
    C = cluster_size
    if tri_ids is None:
        tri_ids = np.arange(geom.num_tris, dtype=np.int64)
    tri_ids = np.asarray(tri_ids, np.int64)
    has_mb = bool(geom.face_mb.cpu().numpy()[tri_ids].any())
    bb_min, bb_max, p0, e1, e2, q0, q1, q2, tri = \
        native.build_clusters_native(
            geom.vertices.cpu().numpy(), geom.vertices_t1.cpu().numpy(),
            geom.face_v.cpu().numpy(), tri_ids, C, has_mb)
    M = max(len(tri), 1)
    pad = -(-M // pad_clusters_to) * pad_clusters_to - len(tri)
    if pad:
        def padrow(x, fill):
            w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, w, constant_values=fill)
        bb_min = padrow(bb_min, NEVER)
        bb_max = padrow(bb_max, NEVER)
        p0, e1, e2 = (padrow(x, 0.0) for x in (p0, e1, e2))
        if has_mb:
            q0, q1, q2 = (padrow(x, 0.0) for x in (q0, q1, q2))
        tri = padrow(tri, -1)
    t = torch.from_numpy
    p0, e1, e2 = t(p0), t(e1), t(e2)
    q0, q1, q2 = (t(q0), t(q1), t(q2)) if has_mb else (p0, e1, e2)
    return Clusters(bb_min=t(bb_min), bb_max=t(bb_max), p0=p0, e1=e1,
                    e2=e2, p0_t1=q0, e1_t1=q1, e2_t1=q2, tri=t(tri),
                    cluster_size=C)


@dataclass
class InstancedClusters(TensorData):
    """Two-level cluster tables: object-space prototype clusters shared by
    every instance, an instance table, and a flat segment table, in the
    JAX package's layout (field meanings as in
    raytracer_tpu/geometry/clusters.py:InstancedClusters). Lane paddings
    hold never-hit point boxes, identity transforms and id -1."""
    ibb: torch.Tensor          # (6, I) f32 instance world boxes, lane-padded
    iminv: torch.Tensor        # (I, 12) f32 world -> object affine rows
    imeta: torch.Tensor        # (I, 2) i32 [prototype, scene.instances row]
    pbb: torch.Tensor          # (P*6, MP) f32 prototype cluster boxes
    pmeta: torch.Tensor        # (P, 2) i32 [pool row offset, cluster count]
    tri: torch.Tensor          # (Mtot, C) i32 global triangle ids, -1 pad
    sbb: torch.Tensor          # (6, E) f32 segment world boxes, lane-padded
    smeta: torch.Tensor        # (E, 3) i32 [inst row, base pool row,
                               #             scene.instances row]
    strf: torch.Tensor         # (E, 12) f32 per-segment world -> object
    pool_proto: torch.Tensor   # (Mtot,) i32 prototype of each pool row
    pool_local: torch.Tensor   # (Mtot,) i32 cluster id within it
    p0: torch.Tensor           # (Mtot*3, C) f32 MT basis [row = 3m + comp]
    e1: torch.Tensor           # (Mtot*3, C)
    e2: torch.Tensor           # (Mtot*3, C)
    cluster_size: int = 128
    num_instances: int = 0
    num_entries: int = 0
    max_proto_clusters: int = 0

    @property
    def num_clusters(self) -> int:
        return self.tri.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel()
                   * getattr(self, f.name).element_size()
                   for f in dataclasses.fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor))


def build_instanced_clusters(geom: Geometry, instances: list[dict],
                             inst_table: Instances, cluster_size: int = 128
                             ) -> tuple[InstancedClusters | None,
                                        Clusters | None]:
    """Two-level cluster build (raytracer_tpu/geometry/clusters.py
    :build_instanced_clusters), numpy on the host.

    instances: the SceneBuilder's dicts (m (3, 4); lo/hi prototype
    triangle range, or tris= explicit world triangle ids), in the row order
    of inst_table. Returns (iclusters, mb_clusters): the motion-blurred
    world triangles go into a single-level table of their own, traced
    apart and merged by nearest t; iclusters is None when the world is all
    motion-blurred and no prototype is placed. A scene with a
    motion-blurred prototype gets no cluster tables, (None, None), and
    traces through its BVH (raytracer_tpu/geometry/clusters.py:276)."""
    face_mb = geom.face_mb.cpu().numpy()
    proto_keys: dict = {}
    entries = []                 # (key, instance row) per kept instance
    mb_world: list[np.ndarray] = []
    for row, inst in enumerate(instances):
        if inst['tris'] is not None:
            tri_ids = np.asarray(inst['tris'], np.int64)
            mb_world.append(tri_ids[face_mb[tri_ids]])
            tri_ids = tri_ids[~face_mb[tri_ids]]
            if len(tri_ids) == 0:
                continue                  # the world is all motion-blurred
            key = ('world', tri_ids.tobytes())
        else:
            key = (inst['lo'], inst['hi'])
            tri_ids = np.arange(inst['lo'], inst['hi'], dtype=np.int64)
            if key not in proto_keys and face_mb[tri_ids].any():
                return None, None       # the BVH tracer's alone
        if key not in proto_keys:
            proto_keys[key] = (len(proto_keys), tri_ids)
        entries.append((key, row))

    mb_world = np.concatenate(mb_world) if mb_world else np.zeros(0, np.int64)
    mb_clusters = (build_clusters(geom, cluster_size, tri_ids=mb_world)
                   if len(mb_world) else None)
    if not proto_keys:
        return None, mb_clusters

    # per-prototype object-space tables, padded to KIN rows
    C = cluster_size
    tabs = [None] * len(proto_keys)
    for pidx, tri_ids in proto_keys.values():
        tab = build_clusters(geom, C, pad_clusters_to=KIN, tri_ids=tri_ids)
        tabs[pidx] = {k: getattr(tab, k).numpy()
                      for k in ('bb_min', 'bb_max', 'p0', 'e1', 'e2', 'tri')}
    P = len(tabs)
    proto_len = np.asarray([t['tri'].shape[0] for t in tabs], np.int64)
    proto_off = np.concatenate([[0], np.cumsum(proto_len)[:-1]])
    Mtot = int(proto_len.sum())

    cat = lambda k: np.concatenate([t[k] for t in tabs])
    p0 = cat('p0').reshape(Mtot * 3, C)
    e1 = cat('e1').reshape(Mtot * 3, C)
    e2 = cat('e2').reshape(Mtot * 3, C)
    tri = cat('tri').astype(np.int32)
    pmeta = np.stack([proto_off, proto_len], 1).astype(np.int32)

    MP = -(-int(proto_len.max()) // 128) * 128
    pbb = np.full((P * 6, MP), NEVER, np.float32)
    for p in range(P):
        n = int(proto_len[p])
        pbb[6 * p:6 * p + 3, :n] = tabs[p]['bb_min'].T
        pbb[6 * p + 3:6 * p + 6, :n] = tabs[p]['bb_max'].T

    # instance table, lane-padded to 128 with never-hit boxes
    n_inst = len(entries)
    I = -(-n_inst // 128) * 128
    ibb = np.full((6, I), NEVER, np.float32)
    iminv = np.tile(np.eye(3, 4, dtype=np.float32).reshape(1, 12), (I, 1))
    imeta = np.zeros((I, 2), np.int32)
    m_all = inst_table.m.numpy()
    minv_all = inst_table.m_inv.numpy()

    # per-prototype KIN-run object boxes (union of the run's real clusters)
    chunk_lo, chunk_hi = [], []
    for t in tabs:
        lo = t['bb_min'].reshape(-1, KIN, 3)
        hi = t['bb_max'].reshape(-1, KIN, 3)
        real = (lo[..., 0] < 1e37)[..., None]
        chunk_lo.append(np.where(real, lo, np.inf).min(1))
        chunk_hi.append(np.where(real, hi, -np.inf).max(1))

    ent_rows = np.asarray([row for _, row in entries], np.int64)
    ent_pidx = np.asarray([proto_keys[key][0] for key, _ in entries],
                          np.int64)
    bits = ((np.arange(8)[:, None] >> np.asarray([2, 1, 0])) & 1) \
        .astype(np.float32)                              # (8, 3) corner mask

    def world_boxes(m, lo, hi):
        """m (k, 3, 4); object boxes lo/hi (nc, 3) -> world lo/hi
        (k, nc, 3) through the 8 corners (src/ProxyObject.cpp:97-130)."""
        corners = lo[:, None] * (1 - bits)[None] + hi[:, None] * bits[None]
        wc = np.einsum('kij,cqj->kcqi', m[:, :, :3], corners) \
            + m[:, None, None, :, 3]                     # (k, nc, 8, 3)
        return wc.min(2), wc.max(2)

    seg_per_proto = np.asarray([len(c) for c in chunk_lo])
    ent_nseg = seg_per_proto[ent_pidx]
    ent_seg0 = np.concatenate([[0], np.cumsum(ent_nseg)[:-1]])
    n_ent = int(ent_nseg.sum())
    sb_lo = np.empty((n_ent, 3), np.float32)
    sb_hi = np.empty((n_ent, 3), np.float32)
    sm = np.empty((n_ent, 3), np.int32)
    for p in range(P):
        sel = np.flatnonzero(ent_pidx == p)
        if len(sel) == 0:
            continue
        m = m_all[ent_rows[sel]]                         # (k, 3, 4)
        real = tabs[p]['bb_min'][:, 0] < 1e37
        bmn = tabs[p]['bb_min'][real].min(0, keepdims=True)
        bmx = tabs[p]['bb_max'][real].max(0, keepdims=True)
        wlo, whi = world_boxes(m, bmn, bmx)              # (k, 1, 3)
        ibb[:3, sel] = wlo[:, 0].T
        ibb[3:, sel] = whi[:, 0].T
        iminv[sel] = minv_all[ent_rows[sel]].reshape(-1, 12)
        imeta[sel, 0] = p
        imeta[sel, 1] = ent_rows[sel]

        slo, shi = world_boxes(m, chunk_lo[p], chunk_hi[p])  # (k, nc, 3)
        nc = len(chunk_lo[p])
        segids = (ent_seg0[sel][:, None] + np.arange(nc)[None]).reshape(-1)
        sb_lo[segids] = slo.reshape(-1, 3)
        sb_hi[segids] = shi.reshape(-1, 3)
        sm[segids, 0] = np.repeat(sel, nc)
        sm[segids, 1] = int(proto_off[p]) + np.tile(np.arange(nc) * KIN,
                                                    len(sel))
        sm[segids, 2] = np.repeat(ent_rows[sel], nc)
    E = -(-n_ent // 128) * 128
    sbb = np.full((6, E), NEVER, np.float32)
    sbb[:3, :n_ent] = sb_lo.T
    sbb[3:, :n_ent] = sb_hi.T
    smeta = np.zeros((E, 3), np.int32)
    smeta[:n_ent] = sm
    strf = np.tile(np.eye(3, 4, dtype=np.float32).reshape(1, 12), (E, 1))
    strf[:n_ent] = iminv[smeta[:n_ent, 0]]

    t = torch.from_numpy
    return InstancedClusters(
        ibb=t(ibb), iminv=t(iminv.astype(np.float32)), imeta=t(imeta),
        pbb=t(pbb), pmeta=t(pmeta), tri=t(tri), sbb=t(sbb), smeta=t(smeta),
        strf=t(strf), p0=t(p0), e1=t(e1), e2=t(e2),
        pool_proto=t(np.repeat(np.arange(P, dtype=np.int32), proto_len)),
        pool_local=t(np.concatenate(
            [np.arange(n, dtype=np.int32) for n in proto_len])),
        cluster_size=C, num_instances=n_inst, num_entries=n_ent,
        max_proto_clusters=int(proto_len.max())), mb_clusters


def _basis(verts, faces, valid):
    """MT basis (p0, p1 - p0, p2 - p0) of faces (..., 3) -> three
    (..., 3) tensors, zero on padding lanes (det == 0: never hit)."""
    p0 = verts[faces[..., 0]]
    return tuple(torch.where(valid[..., None], x, 0.0)
                 for x in (p0, verts[faces[..., 1]] - p0,
                           verts[faces[..., 2]] - p0))


def _corner_boxes(pts, valid):
    """Per-row box of corners pts (M, C, k, 3) over the valid lanes ->
    lo, hi (M, 3); rows without a valid lane get the never-hit box."""
    m4 = valid[..., None, None]
    lo = torch.where(m4, pts, torch.inf).amin(dim=(1, 2))
    hi = torch.where(m4, pts, -torch.inf).amax(dim=(1, 2))
    anyv = valid.any(dim=1)[:, None]
    never = torch.tensor(NEVER, device=pts.device)
    return torch.where(anyv, lo, never), torch.where(anyv, hi, never)


@torch.no_grad()
def refresh_clusters(clusters: Clusters, geom: Geometry, mb: bool) -> Clusters:
    """The table re-derived from the CURRENT vertices (raytracer_tpu
    /geometry/clusters.py:refresh_clusters): the MT basis and the boxes,
    which bound both poses when `mb`. Topology stays fixed; rows without
    a triangle keep the never-hit 3e37 box. A static table's t = 1 tensors
    stay its t = 0 tensors."""
    valid = clusters.tri >= 0
    faces = geom.face_v[clusters.tri.clamp(min=0).long()].long()
    p0, e1, e2 = _basis(geom.vertices.detach(), faces, valid)
    pts = torch.stack([p0, p0 + e1, p0 + e2], dim=2)      # (M, C, 3, 3)
    if mb:
        q0, q1, q2 = _basis(geom.vertices_t1.detach(), faces, valid)
        pts = torch.cat([pts, torch.stack([q0, q0 + q1, q0 + q2], dim=2)],
                        dim=2)
    bb_min, bb_max = _corner_boxes(pts, valid)
    soa = lambda x: x.transpose(1, 2).contiguous()    # (M, C, 3) -> (M, 3, C)
    p0, e1, e2 = soa(p0), soa(e1), soa(e2)
    q0, q1, q2 = (soa(q0), soa(q1), soa(q2)) if mb else (p0, e1, e2)
    return dataclasses.replace(clusters, bb_min=bb_min, bb_max=bb_max,
                               p0=p0, e1=e1, e2=e2, p0_t1=q0, e1_t1=q1,
                               e2_t1=q2)


def _world_boxes(lo, hi, m):
    """Object boxes lo, hi (K, 3) through affine maps m (K, 3, 4) -> world
    lo, hi (K, 3), over the 8 corners (src/ProxyObject.cpp:97-130)."""
    bits = ((torch.arange(8, device=lo.device)[:, None]
             >> torch.tensor([2, 1, 0], device=lo.device)) & 1).float()
    c = lo[:, None] * (1 - bits)[None] + hi[:, None] * bits[None]  # (K, 8, 3)
    m = m[:, None]
    wc = torch.stack([m[..., i, 0] * c[..., 0] + m[..., i, 1] * c[..., 1]
                      + m[..., i, 2] * c[..., 2] + m[..., i, 3]
                      for i in range(3)], dim=-1)                  # (K, 8, 3)
    return wc.amin(dim=1), wc.amax(dim=1)


@torch.no_grad()
def refresh_iclusters(icl: InstancedClusters, geom: Geometry,
                      inst_table: Instances) -> InstancedClusters:
    """The two-level tables re-derived from the CURRENT vertices
    (raytracer_tpu/geometry/clusters.py:refresh_iclusters): the pool's MT
    basis, the prototype cluster boxes (pbb), the instance world boxes
    (ibb) and the segment world boxes (sbb). Topology and the instance
    transforms stay fixed."""
    tri = icl.tri
    Mtot, C = tri.shape
    dev = tri.device
    valid = tri >= 0
    faces = geom.face_v[tri.clamp(min=0).long()].long()
    p0, e1, e2 = _basis(geom.vertices.detach(), faces, valid)
    cb_lo, cb_hi = _corner_boxes(
        torch.stack([p0, p0 + e1, p0 + e2], dim=2), valid)   # (Mtot, 3)

    # the cluster boxes into the (P*6, MP) lane layout
    gp = icl.pool_proto.long()
    lc = icl.pool_local.long()[:, None]
    rows_lo = 6 * gp[:, None] + torch.arange(3, device=dev)
    pbb = icl.pbb.clone()
    pbb[rows_lo, lc] = cb_lo
    pbb[rows_lo + 3, lc] = cb_hi

    # prototype boxes -> instance world boxes
    P = icl.pmeta.shape[0]
    safe_lo = torch.where(cb_lo < 1e37, cb_lo, torch.inf)
    safe_hi = torch.where(cb_hi < 1e37, cb_hi, -torch.inf)
    seg = gp[:, None].expand(-1, 3)
    plo = torch.full((P, 3), torch.inf, device=dev).scatter_reduce(
        0, seg, safe_lo, 'amin', include_self=False)
    phi = torch.full((P, 3), -torch.inf, device=dev).scatter_reduce(
        0, seg, safe_hi, 'amax', include_self=False)
    m_all = inst_table.m.detach()
    NI = icl.num_instances
    imeta = icl.imeta.long()
    wlo, whi = _world_boxes(plo[imeta[:NI, 0]], phi[imeta[:NI, 0]],
                            m_all[imeta[:NI, 1]])
    ibb = icl.ibb.clone()
    ibb[:3, :NI] = wlo.T
    ibb[3:, :NI] = whi.T

    # KIN-cluster chunk boxes -> segment world boxes
    ch_lo = safe_lo.reshape(-1, KIN, 3).amin(dim=1)
    ch_hi = safe_hi.reshape(-1, KIN, 3).amax(dim=1)
    nE = icl.num_entries
    smeta = icl.smeta.long()
    cid = smeta[:nE, 1] // KIN
    slo, shi = _world_boxes(ch_lo[cid], ch_hi[cid], m_all[smeta[:nE, 2]])
    sbb = icl.sbb.clone()
    sbb[:3, :nE] = slo.T
    sbb[3:, :nE] = shi.T

    soa = lambda x: x.transpose(1, 2).reshape(Mtot * 3, C)
    return dataclasses.replace(icl, p0=soa(p0), e1=soa(e1), e2=soa(e2),
                               pbb=pbb, ibb=ibb, sbb=sbb)
