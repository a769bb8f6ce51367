"""Host-side mesh arrays (numpy), copied from raytracer_tpu/io/objload.py.

`load_obj` comes with the scenes that read model files (ROADMAP queue 1 #9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    """Host-side mesh arrays, pre-concatenation."""
    vertices: np.ndarray          # (V,3) f32
    normals: np.ndarray           # (N,3) f32
    texcoords: np.ndarray | None  # (U,2) f32 or None
    face_v: np.ndarray            # (T,3) i32
    face_n: np.ndarray            # (T,3) i32
    face_t: np.ndarray | None     # (T,3) i32 or None
    tangents: np.ndarray = None   # (N,3) filled by compute_tangents
    bitangents: np.ndarray = None

    @property
    def num_tris(self) -> int:
        return len(self.face_v)


def compute_tangents(mesh: MeshData) -> None:
    """Per-corner tangent frames from UV edges, Gram-Schmidt vs the normal.

    Mirrors TriangleMesh::preCalc (reference: src/TriangleMesh.cpp:107-152):
      cp = e1uv.y*e2uv.x - e1uv.x*e2uv.y
      tangent = normalize((AB * -e2uv.x + AC * e1uv.y) / cp)
      T[n] = normalize(tangent - N*dot(N, tangent)); BT[n] = cross(T[n], N)
    Indexed by *normal* index as in the reference (last triangle writing a
    shared normal index wins).
    """
    n = len(mesh.normals)
    tangents = np.zeros((n, 3), np.float32)
    bitangents = np.zeros((n, 3), np.float32)
    if mesh.texcoords is not None:
        v = mesh.vertices
        t = mesh.texcoords
        A = v[mesh.face_v[:, 0]]
        AB = v[mesh.face_v[:, 1]] - A
        AC = v[mesh.face_v[:, 2]] - A
        t0 = t[mesh.face_t[:, 0]]
        e1uv = t[mesh.face_t[:, 1]] - t0
        e2uv = t[mesh.face_t[:, 2]] - t0
        cp = e1uv[:, 1] * e2uv[:, 0] - e1uv[:, 0] * e2uv[:, 1]
        ok = cp != 0.0
        mul = np.where(ok, 1.0 / np.where(ok, cp, 1.0), 0.0)[:, None]
        tang = (AB * -e2uv[:, 0:1] + AC * e1uv[:, 1:2]) * mul
        tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-20)
        for corner in range(3):
            idx = mesh.face_n[:, corner]
            nrm = mesh.normals[idx]
            tt = tang - nrm * np.sum(nrm * tang, axis=-1, keepdims=True)
            tt /= np.maximum(np.linalg.norm(tt, axis=-1, keepdims=True), 1e-20)
            bt = np.cross(tt, nrm)
            sel = np.where(ok)[0]
            tangents[idx[sel]] = tt[sel]
            bitangents[idx[sel]] = bt[sel]
    mesh.tangents = tangents
    mesh.bitangents = bitangents


def make_single_triangle(v0, v1, v2, n=None) -> MeshData:
    """One-triangle mesh (reference: TriangleMesh::createSingleTriangle)."""
    vertices = np.asarray([v0, v1, v2], np.float32)
    if n is None:
        nrm = np.cross(vertices[1] - vertices[0], vertices[2] - vertices[0])
        nrm = (nrm / max(np.linalg.norm(nrm), 1e-20)).astype(np.float32)
    else:
        nrm = np.asarray(n, np.float32)
    return MeshData(
        vertices=vertices,
        normals=np.repeat(nrm[None], 3, 0),
        texcoords=None,
        face_v=np.asarray([[0, 1, 2]], np.int32),
        face_n=np.asarray([[0, 1, 2]], np.int32),
        face_t=None,
    )
