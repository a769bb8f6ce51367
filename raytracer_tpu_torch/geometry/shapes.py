"""Procedural mesh generators (host-side numpy).

The reference has no procedural shapes (its Sphere class is dead code,
src/Sphere.cpp); these generators supply test fixtures and stand-ins for
models the reference scenes reference but don't ship (bunny.obj, dragon_2.obj,
sponza.obj — see BASELINE.md).
"""
from __future__ import annotations

import numpy as np

from ..io.objload import MeshData


def uv_sphere(center=(0, 0, 0), radius=1.0, n_lat=16, n_lon=32,
              with_uv: bool = True) -> MeshData:
    """UV sphere with smooth normals."""
    center = np.asarray(center, np.float32)
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(lat, lon, indexing='ij')    # (n_lat+1, n_lon+1)
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    verts = center + radius * pts
    normals = pts.copy()
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)

    def vid(i, j):
        return i * (n_lon + 1) + j

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b_, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                faces.append((a, c, b_))
            if i < n_lat - 1:
                faces.append((b_, c, d))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=verts, normals=normals.astype(np.float32),
                    texcoords=uv.astype(np.float32) if with_uv else None,
                    face_v=face_v, face_n=face_v.copy(),
                    face_t=face_v.copy() if with_uv else None)


def quad(v0, v1, v2, v3, with_uv: bool = True) -> MeshData:
    """Two-triangle quad v0-v1-v2-v3 (counter-clockwise)."""
    verts = np.asarray([v0, v1, v2, v3], np.float32)
    n = np.cross(verts[1] - verts[0], verts[3] - verts[0])
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
    face_v = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshData(vertices=verts, normals=np.repeat(n[None], 4, 0),
                    texcoords=uv if with_uv else None,
                    face_v=face_v,
                    face_n=face_v.copy(),
                    face_t=face_v.copy() if with_uv else None)


def box(lo, hi) -> MeshData:
    """Axis-aligned box with outward flat normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       np.float32)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]
    verts, norms, faces = [], [], []
    for q in quads:
        base = len(verts)
        pts = corners[list(q)]
        n = np.cross(pts[1] - pts[0], pts[3] - pts[0])
        n /= max(np.linalg.norm(n), 1e-20)
        verts.extend(pts)
        norms.extend([n] * 4)
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32),
                    texcoords=None, face_v=face_v, face_n=face_v.copy(),
                    face_t=None)


def cylinder(center, radius, height, n_seg=24) -> MeshData:
    """Open cylinder (columns for the sponza stand-in)."""
    center = np.asarray(center, np.float32)
    ang = np.linspace(0, 2 * np.pi, n_seg + 1)[:-1]
    ring = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], -1)
    bot = center + radius * ring
    top = bot + np.asarray([0, height, 0], np.float32)
    verts = np.concatenate([bot, top]).astype(np.float32)
    normals = np.concatenate([ring, ring]).astype(np.float32)
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append((i, n_seg + i, j))
        faces.append((j, n_seg + i, n_seg + j))
    face_v = np.asarray(faces, np.int32)
    return MeshData(vertices=verts, normals=normals, texcoords=None,
                    face_v=face_v, face_n=face_v.copy(), face_t=None)
