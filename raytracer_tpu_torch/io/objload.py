"""Wavefront OBJ loader and host-side mesh arrays (numpy), copied from
raytracer_tpu/io/objload.py.

Behavioral mirror of the reference two-pass parser
(reference: src/TriangleMeshLoad.cpp:49-214): v/vn/vt and f records with
v, v/t, v//n, v/t/n corners, polygons fan-triangulated; negative indices
count back from the current record counts. Vertices may be transformed by a
3x4 CTM at load, normals by its inverse-transpose
(src/TriangleMeshLoad.cpp:120-140). Face normals are generated when the file
has none (src/TriangleMeshLoad.cpp:186-205). The native parser
(native/rt_native.cpp) and the Python parser give the same arrays.
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


def _parse_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def load_obj(path: str, ctm: np.ndarray | None = None) -> MeshData:
    """Parse an OBJ file into numpy arrays with this package's C++
    two-pass parser (native/rt_native.cpp, the reference's native loader,
    src/TriangleMeshLoad.cpp:49-214), as the JAX package prefers it; a
    file without vertices or faces goes to the Python parser
    (`_load_obj_python`), as in the JAX package. ctm: optional (3,4) or
    (4,4) affine transform applied to vertices; normals get the
    inverse-transpose of its linear part, then renormalized (reference:
    src/TriangleMeshLoad.cpp:120-140).
    """
    from .. import native
    nat = native.parse_obj_native(path)
    if nat is None:
        return _load_obj_python(path, ctm)
    return _postprocess(nat['v'], nat['vn'] if nat['has_n'] else None,
                        nat['vt'] if nat['has_t'] else None,
                        nat['fv'], nat['fn'], nat['ft'],
                        nat['has_n'], nat['has_t'], ctm)


def _load_obj_python(path: str, ctm: np.ndarray | None) -> MeshData:
    """The plain Python parser: the same arrays as the native one."""
    verts: list[tuple] = []
    norms: list[tuple] = []
    uvs: list[tuple] = []
    fv: list[tuple] = []
    fn: list[tuple] = []
    ft: list[tuple] = []
    any_n = False
    any_t = False

    with open(path, 'r', errors='replace') as f:
        for line in f:
            if not line or line[0] in '#\n\r':
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == 'v':
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == 'vn':
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == 'vt':
                uvs.append((float(parts[1]), float(parts[2])))
            elif tag == 'f':
                corners = parts[1:]
                # fan-triangulate polygons (reference only handles tris; the
                # shipped models are triangulated, but be robust)
                cs = []
                for c in corners:
                    sub = c.split('/')
                    vi = _parse_index(sub[0], len(verts))
                    ti = _parse_index(sub[1], len(uvs)) if len(sub) > 1 and sub[1] else -1
                    ni = _parse_index(sub[2], len(norms)) if len(sub) > 2 and sub[2] else -1
                    cs.append((vi, ti, ni))
                for k in range(1, len(cs) - 1):
                    tri = (cs[0], cs[k], cs[k + 1])
                    fv.append(tuple(c[0] for c in tri))
                    ft.append(tuple(c[1] for c in tri))
                    fn.append(tuple(c[2] for c in tri))
                    if tri[0][2] >= 0:
                        any_n = True
                    if tri[0][1] >= 0:
                        any_t = True

    vertices = np.asarray(verts, np.float32).reshape(-1, 3)
    face_v = np.asarray(fv, np.int32).reshape(-1, 3)
    norms_arr = np.asarray(norms, np.float32).reshape(-1, 3) if norms else None
    uvs_arr = np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else None
    face_n = np.asarray(fn, np.int32).reshape(-1, 3) if fn else None
    face_t = np.asarray(ft, np.int32).reshape(-1, 3) if ft else None
    return _postprocess(vertices, norms_arr, uvs_arr, face_v, face_n, face_t,
                        any_n, any_t, ctm)


def _postprocess(vertices, norms, uvs, face_v, face_n, face_t,
                 any_n, any_t, ctm) -> MeshData:
    vertices = np.asarray(vertices, np.float32)
    face_v = np.asarray(face_v, np.int32)
    if ctm is not None:
        ctm = np.asarray(ctm, np.float32)
        lin = ctm[:3, :3]
        trans = ctm[:3, 3] if ctm.shape[1] == 4 else np.zeros(3, np.float32)
        vertices = vertices @ lin.T + trans

    if any_n and norms is not None and len(norms):
        normals = np.asarray(norms, np.float32)
        face_n = np.asarray(face_n, np.int32)
        if ctm is not None:
            inv_t = np.linalg.inv(ctm[:3, :3]).T
            normals = normals @ inv_t.T
            normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    else:
        # generate per-face normals (flat shading), one normal per face
        e0 = vertices[face_v[:, 1]] - vertices[face_v[:, 0]]
        e1 = vertices[face_v[:, 2]] - vertices[face_v[:, 0]]
        normals = np.cross(e0, e1).astype(np.float32)
        normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
        face_n = np.repeat(np.arange(len(face_v), dtype=np.int32)[:, None], 3, axis=1)

    if any_t and uvs is not None and len(uvs):
        texcoords = np.asarray(uvs, np.float32)
        face_t = np.asarray(face_t, np.int32)
    else:
        texcoords = None
        face_t = None

    return MeshData(vertices=vertices, normals=normals, texcoords=texcoords,
                    face_v=face_v, face_n=face_n, face_t=face_t)


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


def transform_mesh(mesh: MeshData, m: np.ndarray) -> MeshData:
    """Return a world-space copy of `mesh` under the (3,4)/(4,4) affine `m`.

    Vertices by m; normals by the inverse transpose of the linear part,
    renormalized; tangent frames by the linear part (reference
    loadObj-with-CTM semantics, src/TriangleMeshLoad.cpp:120-140), to bake
    instances into single-level geometry.
    """
    m = np.asarray(m, np.float32)
    if m.shape == (4, 4):
        m = m[:3]
    lin = m[:, :3]
    lin_it = np.linalg.inv(lin).T.astype(np.float32)

    def unit(v):
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return (v / np.maximum(n, 1e-20)).astype(np.float32)

    tangents = mesh.tangents
    bitangents = mesh.bitangents
    return MeshData(
        vertices=(mesh.vertices @ lin.T + m[:, 3]).astype(np.float32),
        normals=unit(mesh.normals @ lin_it.T),
        texcoords=mesh.texcoords,
        face_v=mesh.face_v, face_n=mesh.face_n, face_t=mesh.face_t,
        tangents=None if tangents is None else unit(tangents @ lin.T),
        bitangents=None if bitangents is None else unit(bitangents @ lin.T))
