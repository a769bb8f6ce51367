"""Flat triangle clusters for the cluster tracer (host side).

Port of `Clusters` and `build_clusters` in raytracer_tpu/geometry/clusters.py,
through the same native binned-SAH build, so the table is byte-identical to
the JAX package's. The SAH build is cut into M clusters of <= C triangles;
each cluster stores its AABB and its triangles' Moller-Trumbore basis
(p0, p1 - p0, p2 - p0) as SoA (M, 3, C). Padding lanes hold degenerate
triangles with id -1 and always trail the real lanes of a cluster; padding
rows hold far-away point boxes (lo == hi == 3e37) that fail every slab test.

The motion-blur pose tables (`*_t1`) come with motion blur (ROADMAP queue 1
#11).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import Geometry, TensorData
from .. import native

NEVER = np.float32(3e37)


@dataclass
class Clusters(TensorData):
    """Padded SoA cluster table, M clusters x C triangles."""
    bb_min: torch.Tensor     # (M, 3) f32
    bb_max: torch.Tensor     # (M, 3) f32
    p0: torch.Tensor         # (M, 3, C) f32 [component, lane]
    e1: torch.Tensor         # (M, 3, C)
    e2: torch.Tensor         # (M, 3, C)
    tri: torch.Tensor        # (M, C) i32, -1 = padding
    cluster_size: int = 128

    @property
    def num_clusters(self) -> int:
        return self.tri.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in
                   (self.bb_min, self.bb_max, self.p0, self.e1, self.e2,
                    self.tri))


def build_clusters(geom: Geometry, cluster_size: int = 128,
                   pad_clusters_to: int = 8) -> Clusters:
    """Cut the SAH tree over all of a static geometry's triangles into
    <= cluster_size clusters; pad the row count to a multiple of
    pad_clusters_to."""
    C = cluster_size
    tri_ids = np.arange(geom.num_tris, dtype=np.int64)
    bb_min, bb_max, p0, e1, e2, tri = native.build_clusters_native(
        geom.vertices.cpu().numpy(), geom.face_v.cpu().numpy(), tri_ids, C)
    M = max(len(tri), 1)
    pad = -(-M // pad_clusters_to) * pad_clusters_to - len(tri)
    if pad:
        def padrow(x, fill):
            w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, w, constant_values=fill)
        bb_min = padrow(bb_min, NEVER)
        bb_max = padrow(bb_max, NEVER)
        p0, e1, e2 = (padrow(x, 0.0) for x in (p0, e1, e2))
        tri = padrow(tri, -1)
    t = torch.from_numpy
    return Clusters(bb_min=t(bb_min), bb_max=t(bb_max), p0=t(p0), e1=t(e1),
                    e2=t(e2), tri=t(tri), cluster_size=C)
