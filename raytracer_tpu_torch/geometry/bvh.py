"""Host-side BVH construction (numpy), flattened to wide SoA node arrays.

Port of raytracer_tpu/geometry/bvh.py, the same builds in the same float
order, so the tables are byte-equal to the JAX package's. It mirrors the
reference pipeline BVH_Node binned-SAH build -> QBVH collapse (reference:
src/BVH.cpp:625-1106 build, src/BVH.cpp:100-389 flatten), emits index
arrays instead of pointer trees, and generalizes the 4-wide SSE node to a
branching factor B (default 4).

Two-level structure (reference ProxyObject two-level BVH,
src/ProxyObject.cpp:76-95, src/Scene.cpp:62-79):
  - one BLAS subtree per prototype (and one for the loose world geometry),
    all in a shared node pool, built by the native builder
    (native.build_bvh_native);
  - a TLAS over the instance world boxes whose leaves reference instance
    ids, built by the Python `_build_binary` (as in the JAX package).
The tables stay numpy until `build_scene_bvh` wraps them as tensors; the
topology is integer and non-differentiable.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import native
from ..core import types as T
from ..ops.traverse import MAX_LEAF

NUM_BINS = 8  # reference: src/Miro.h:67


class _Binary:
    """Binary SAH tree in flat numpy arrays (temporary, host-only)."""
    __slots__ = ('bb_min', 'bb_max', 'left', 'right', 'start', 'count', 'n')

    def __init__(self, cap):
        self.bb_min = np.empty((cap, 3), np.float32)
        self.bb_max = np.empty((cap, 3), np.float32)
        self.left = np.full(cap, -1, np.int64)
        self.right = np.full(cap, -1, np.int64)
        self.start = np.full(cap, -1, np.int64)
        self.count = np.zeros(cap, np.int64)
        self.n = 0

    def alloc(self):
        i = self.n
        self.n += 1
        return i


def _build_binary(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int):
    """Binned-SAH binary build over primitive AABBs.

    Returns (_Binary tree, order) where order is the permutation of prim ids
    such that leaves cover contiguous ranges. Mirrors BVH_Node::buildBin /
    partitionSweepBin (src/BVH.cpp:625-793): NUM_BINS bins on centroid extent
    per axis, area sweeps, best-axis split, median fallback.
    """
    n = len(bmin)
    cent = 0.5 * (bmin + bmax)
    order = np.arange(n, dtype=np.int64)
    tree = _Binary(max(2 * n, 4))
    root = tree.alloc()
    stack = [(root, 0, n)]
    while stack:
        node, lo, hi = stack.pop()
        ids = order[lo:hi]
        nb_min = bmin[ids]
        nb_max = bmax[ids]
        tree.bb_min[node] = nb_min.min(0)
        tree.bb_max[node] = nb_max.max(0)
        cnt = hi - lo
        if cnt <= leaf_size:
            tree.start[node] = lo
            tree.count[node] = cnt
            continue
        c = cent[ids]
        c_lo = c.min(0)
        c_hi = c.max(0)
        ext = c_hi - c_lo
        best_cost = np.inf
        best_axis = -1
        best_bin = -1
        binned = None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
            b = np.minimum(((c[:, axis] - c_lo[axis]) * scale).astype(np.int64),
                           NUM_BINS - 1)
            # per-bin counts and bounds
            counts = np.bincount(b, minlength=NUM_BINS)
            bbl = np.full((NUM_BINS, 3), np.inf, np.float32)
            bbh = np.full((NUM_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bbl, b, nb_min)
            np.maximum.at(bbh, b, nb_max)
            # left/right sweeps
            lmin = np.minimum.accumulate(bbl, 0)
            lmax = np.maximum.accumulate(bbh, 0)
            rmin = np.minimum.accumulate(bbl[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bbh[::-1], 0)[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            nl = np.cumsum(counts)[:-1]
            nr = cnt - nl
            cost = area(lmin, lmax)[:-1] * nl + area(rmin[1:], rmax[1:]) * nr
            cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_axis = axis
                best_bin = k
                binned = b
        if best_axis < 0:
            # degenerate (all centroids equal): median split
            mid = lo + cnt // 2
        else:
            mask = binned <= best_bin
            order[lo:hi] = np.concatenate([ids[mask], ids[~mask]])
            mid = lo + int(mask.sum())
            if mid == lo or mid == hi:
                mid = lo + cnt // 2
        l = tree.alloc()
        r = tree.alloc()
        tree.left[node] = l
        tree.right[node] = r
        stack.append((l, lo, mid))
        stack.append((r, mid, hi))
    return tree, order


class _WidePool:
    """Accumulates wide-node blocks across all BLAS subtrees + prim order."""

    def __init__(self, branch: int):
        self.B = branch
        self.blocks: list[tuple] = []  # (node_min, node_max, child, count)
        self.prim_order: list[np.ndarray] = []
        self.prim_off = 0
        self.n_nodes = 0
        self.max_depth = 0

    def add_block(self, node_min, node_max, child, count, ordered_prims,
                  depth) -> int:
        """Append a pre-built subtree block (e.g. from the native builder);
        child ids must already be offset by the current node count."""
        root = self.n_nodes
        self.blocks.append((node_min, node_max, child, count))
        self.n_nodes += len(node_min)
        self.prim_order.append(np.asarray(ordered_prims, np.int64))
        self.prim_off += len(ordered_prims)
        self.max_depth = max(self.max_depth, depth)
        return root

    def add_subtree(self, tree: _Binary, order: np.ndarray,
                    prim_ids: np.ndarray) -> int:
        """Collapse the binary tree to wide nodes; returns root wide-node id.

        Collapse rule mirrors QBVH_Node::build (src/BVH.cpp:100-389): each
        wide node's children are the grandchildren of a binary node (children
        that are leaves stay as direct slots).
        """
        B = self.B
        out_min, out_max, out_child, out_count = [], [], [], []

        def collect(b: int, depth: int) -> list[int]:
            """Expand binary node ids until B slots, largest-area first."""
            slots = [b]
            def node_area(i):
                d = np.maximum(tree.bb_max[i] - tree.bb_min[i], 0)
                return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
            while len(slots) < B:
                # pick the internal slot with the largest area to expand
                cand = [(node_area(s), k) for k, s in enumerate(slots)
                        if tree.left[s] >= 0]
                if not cand:
                    break
                _, k = max(cand)
                s = slots.pop(k)
                slots.extend([tree.left[s], tree.right[s]])
            return slots

        sub_depth = [0]

        def emit(b: int, depth: int) -> int:
            my_id = len(out_min)
            out_min.append(np.full((B, 3), np.float32(np.inf)))
            out_max.append(np.full((B, 3), np.float32(-np.inf)))
            out_child.append(np.full(B, -1, np.int64))
            out_count.append(np.full(B, -1, np.int64))
            sub_depth[0] = max(sub_depth[0], depth + 1)
            slots = collect(b, depth)
            for c, s in enumerate(slots):
                out_min[my_id][c] = tree.bb_min[s]
                out_max[my_id][c] = tree.bb_max[s]
                if tree.left[s] < 0:  # binary leaf
                    out_child[my_id][c] = self.prim_off + tree.start[s]
                    out_count[my_id][c] = tree.count[s]
                else:
                    out_count[my_id][c] = 0
                    out_child[my_id][c] = emit(s, depth + 1)
            return my_id

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            # root is emitted first so subtree root id == current pool length
            root_local = emit(0, 0)
        finally:
            sys.setrecursionlimit(old)
        assert root_local == 0
        node_offset = self.n_nodes
        # fix child ids by offsetting internal links
        for i in range(len(out_child)):
            internal = out_count[i] == 0
            out_child[i][internal] += node_offset
        return self.add_block(np.stack(out_min), np.stack(out_max),
                              np.stack(out_child), np.stack(out_count),
                              prim_ids[order], sub_depth[0])

    def _stacked(self):
        node_min = np.concatenate([b[0] for b in self.blocks]).astype(np.float32)
        node_max = np.concatenate([b[1] for b in self.blocks]).astype(np.float32)
        child = np.concatenate([b[2] for b in self.blocks]).astype(np.int64)
        count = np.concatenate([b[3] for b in self.blocks]).astype(np.int64)
        return node_min, node_max, child, count


def triangle_aabbs(geom: T.Geometry, tris: np.ndarray):
    """Per-triangle AABBs; motion-blurred triangles get the union of both
    time steps' boxes (reference MBObject::getAABB, src/MBObject.cpp)."""
    v = geom.vertices.cpu().numpy()
    v1 = geom.vertices_t1.cpu().numpy()
    f = geom.face_v.cpu().numpy()[tris]
    p0 = np.stack([v[f[:, k]] for k in range(3)], 1)       # (T,3,3)
    p1 = np.stack([v1[f[:, k]] for k in range(3)], 1)
    allp = np.concatenate([p0, p1], 1)
    return allp.min(1).astype(np.float32), allp.max(1).astype(np.float32)


def instance_table(instances: list[dict], n_tris: int,
                   roots=None) -> T.Instances:
    """The instance rows (raytracer_tpu/geometry/bvh.py:282-317): m, one
    float32 inverse of each 3x3 then -(minv @ t), its transpose, and each
    prototype's triangle range (the world's: all triangles); `roots`, the
    BLAS root of each row, when the BVH is built."""
    ms, minvs, minvts, los, his = [], [], [], [], []
    for inst in instances:
        m = np.asarray(inst['m'], np.float32)
        minv_lin = np.linalg.inv(m[:, :3])
        minv = np.concatenate([minv_lin, -(minv_lin @ m[:, 3])[:, None]], 1)
        ms.append(m)
        minvs.append(minv.astype(np.float32))
        minvts.append(minv_lin.T.astype(np.float32))
        los.append(inst['lo'] if inst['lo'] >= 0 else 0)
        his.append(inst['hi'] if inst['hi'] >= 0 else n_tris)
    t = torch.from_numpy
    return T.Instances(
        m=t(np.stack(ms)), m_inv=t(np.stack(minvs)),
        m_inv_t=t(np.stack(minvts)), tri_lo=t(np.asarray(los, np.int32)),
        tri_hi=t(np.asarray(his, np.int32)),
        root=None if roots is None else t(np.asarray(roots, np.int32)))


def build_scene_bvh(geom: T.Geometry, instances: list[dict],
                    leaf_size: int = 4, branch: int = 4):
    """Build the BLAS pool, the instance table and the TLAS -> (merged
    BVHArrays, Instances with BLAS roots, entry node), as CPU tensors.

    `instances`: the SceneBuilder's dicts, with keys m (3,4) and lo/hi (a
    prototype's triangle range) or tris (the world's triangle ids).
    leaf_size is the JAX signature's and must be MAX_LEAF: both tracers
    (ops/traverse.py, csrc/bvh_trace.cu) test MAX_LEAF lanes a leaf, so a
    wider leaf's other triangles would be skipped.
    """
    if leaf_size != MAX_LEAF:
        raise ValueError(f'leaf_size {leaf_size}: the tracers walk leaves '
                         f'of {MAX_LEAF} triangles')
    pool = _WidePool(branch)

    # one BLAS per distinct triangle set (prototypes shared across instances)
    blas_roots: dict = {}

    def blas_for(key, tri_ids):
        if key not in blas_roots:
            bmin, bmax = triangle_aabbs(geom, tri_ids)
            nmin, nmax, child, count, order, depth = native.build_bvh_native(
                bmin, bmax, leaf_size, branch, pool.prim_off, pool.n_nodes)
            root = pool.add_block(nmin, nmax, child, count, tri_ids[order],
                                  depth)
            blas_roots[key] = (root, bmin.min(0), bmax.max(0))
        return blas_roots[key]

    roots, world_min, world_max = [], [], []
    for inst in instances:
        if inst['tris'] is not None:
            tri_ids = np.asarray(inst['tris'], np.int64)
            key = ('world',)
        else:
            tri_ids = np.arange(inst['lo'], inst['hi'], dtype=np.int64)
            key = (inst['lo'], inst['hi'])
        root, bmn, bmx = blas_for(key, tri_ids)
        roots.append(root)
        m = np.asarray(inst['m'], np.float32)
        # world AABB: transform the 8 BLAS root box corners
        # (reference ProxyObject::getAABB, src/ProxyObject.cpp:97-130)
        cs = np.array([[x, y, z]
                       for x in (bmn[0], bmx[0])
                       for y in (bmn[1], bmx[1])
                       for z in (bmn[2], bmx[2])], np.float32)
        wc = cs @ m[:, :3].T + m[:, 3]
        world_min.append(wc.min(0))
        world_max.append(wc.max(0))
    inst_table = instance_table(instances, geom.face_v.shape[0], roots)

    # TLAS over instance world boxes
    tpool = _WidePool(branch)
    tree, order = _build_binary(np.stack(world_min), np.stack(world_max),
                                leaf_size=MAX_LEAF)
    tpool.add_subtree(tree, order, np.arange(len(instances), dtype=np.int64))

    # merge BLAS pool + TLAS into one node pool (see BVHArrays): TLAS
    # internal children offset by n_blas nodes; TLAS leaves become
    # instance leaves (count -> -(n+1)) pointing past the triangle section
    # of prim_order.
    n_blas = pool.n_nodes
    n_tris = pool.prim_off
    b_min, b_max, b_child, b_count = pool._stacked()
    t_min, t_max, t_child, t_count = tpool._stacked()
    internal = t_count == 0
    leaf = t_count > 0
    t_child = np.where(internal, t_child + n_blas,
                       np.where(leaf, t_child + n_tris, t_child))
    t_count = np.where(leaf, -(t_count + 1), t_count)

    t = torch.from_numpy
    merged = T.BVHArrays(
        node_min=t(np.concatenate([b_min, t_min]).astype(np.float32)),
        node_max=t(np.concatenate([b_max, t_max]).astype(np.float32)),
        child=t(np.concatenate([b_child, t_child]).astype(np.int32)),
        count=t(np.concatenate([b_count, t_count]).astype(np.int32)),
        prim_order=t(np.concatenate(pool.prim_order
                                    + tpool.prim_order).astype(np.int32)),
        depth=pool.max_depth + tpool.max_depth + 2)

    # traversal entry: TLAS root for true two-level scenes, the world BLAS
    # root (node 0) when there is a single identity instance
    single = (len(instances) == 1 and instances[0]['tris'] is not None)
    return merged, inst_table, 0 if single else n_blas
