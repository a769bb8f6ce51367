"""Procedural stand-ins for the model and image files that the JAX
registry's textured, motion-blurred and alpha-mapped scenes read, and that
the repository does not ship: meshes as MeshData and images as float32
(H, W, C) arrays, top row first, each made with numpy from a fixed seed.
Nothing here reads a file.
"""
from __future__ import annotations

import numpy as np

from ..geometry import shapes
from ..io.objload import MeshData


def _grid(h: int, w: int):
    """(u, v) in [0, 1] over an (h, w) image, v = 0 on the top row."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing='ij')
    return u, v


def _noise(h: int, w: int, cell: int, seed: int) -> np.ndarray:
    """Smooth value noise in [0, 1): random values every `cell` pixels,
    interpolated bilinearly between them."""
    rs = np.random.default_rng(seed)
    small = rs.random((h // cell + 2, w // cell + 2))
    fy, fx = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = fy.astype(np.int64), fx.astype(np.int64)
    dy, dx = (fy - y0)[:, None], (fx - x0)[None, :]
    g = lambda y, x: small[y][:, x]
    return (g(y0, x0) * (1 - dy) * (1 - dx) + g(y0, x0 + 1) * (1 - dy) * dx
            + g(y0 + 1, x0) * dy * (1 - dx) + g(y0 + 1, x0 + 1) * dy * dx)


def solid_texture(color, size: int = 32, grain: float = 0.15,
                  seed: int = 0) -> np.ndarray:
    """An RGB colour with a little grain (bark, stems, petals, dirt)."""
    n = _noise(size, size, 4, seed)
    img = np.asarray(color, np.float32) * (1.0 - grain + 2 * grain * n)[..., None]
    return img.astype(np.float32)


def checker_texture(size: int = 64, n: int = 8) -> np.ndarray:
    """Black and white checks (the cannonball's bw2.tga)."""
    u, v = _grid(size, size)
    c = ((np.floor(u * n) + np.floor(v * n)) % 2).astype(np.float32)
    return np.repeat((0.05 + 0.9 * c)[..., None], 3, -1)


def normal_map(size: int = 32, seed: int = 0) -> np.ndarray:
    """A bumpy tangent-space normal map, stored as the raw (x, y, z) the
    shader blends (mostly +z)."""
    n = _noise(size, size, 4, seed) - 0.5
    m = _noise(size, size, 4, seed + 1) - 0.5
    img = np.stack([0.3 * n, 0.3 * m, np.ones_like(n)], -1)
    return (img / np.linalg.norm(img, axis=-1, keepdims=True)).astype(
        np.float32)


def leaf_texture(size: int = 128, color=(0.25, 0.5, 0.12),
                 seed: int = 0) -> np.ndarray:
    """RGBA leaf: a pointed lens along v with a lighter midrib, alpha 1
    inside and 0 outside (an alpha-cutout map, about 40% transparent)."""
    u, v = _grid(size, size)
    x, y = 2 * u - 1, 2 * v - 1
    half = 0.5 * (1 - y * y)
    inside = np.abs(x) < half
    rib = np.abs(x) < 0.04
    shade = 0.75 + 0.5 * _noise(size, size, 8, seed) * (1 - np.abs(y))
    rgb = np.asarray(color, np.float32) * shade[..., None]
    rgb = np.where(rib[..., None], rgb * 1.5, rgb)
    return np.concatenate([rgb, inside[..., None]], -1).astype(np.float32)


def sky_hdr(h: int = 128, w: int = 256, sun_u: float = 0.3,
            sun_el: float = 35.0, sun_power: float = 400.0,
            zenith=(0.2, 0.4, 0.9), horizon=(0.9, 0.9, 1.0),
            ground=(0.25, 0.2, 0.15), sun_width: float = 3.0) -> np.ndarray:
    """A lat-long HDR sky (top row the zenith): a gradient from horizon to
    zenith, a dim ground below the horizon, and a bright sun spot at
    texture column sun_u and elevation sun_el degrees."""
    u, v = _grid(h, w)
    el = 90.0 - 180.0 * v                        # elevation, degrees
    k = np.clip(el / 90.0, 0.0, 1.0)[..., None] ** 0.5
    img = np.where((el >= 0)[..., None],
                   np.asarray(horizon) * (1 - k) + np.asarray(zenith) * k,
                   np.asarray(ground) * np.ones_like(k))
    du = np.minimum(np.abs(u - sun_u), 1 - np.abs(u - sun_u)) * 360.0
    d2 = (du * np.cos(np.radians(sun_el))) ** 2 + (el - sun_el) ** 2
    img = img + (sun_power * np.exp(-d2 / (2 * sun_width ** 2)))[..., None] \
        * np.asarray([1.0, 0.95, 0.85])
    return img.astype(np.float32)


def shattered_sphere(center, radius: float, n_lat: int, n_lon: int,
                     push: float, seed: int) -> tuple[MeshData, MeshData]:
    """A sphere broken into its triangles (no shared vertices) and its t = 1
    pose, each shard pushed outward from the centre by push times a random
    factor in [0.5, 1.5) -> (mesh at t = 0, mesh at t = 1)."""
    s = shapes.uv_sphere(center, radius, n_lat, n_lon, with_uv=True)
    T = s.num_tris
    idx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    verts = s.vertices[s.face_v].reshape(-1, 3)
    m0 = MeshData(vertices=verts.astype(np.float32),
                  normals=s.normals[s.face_n].reshape(-1, 3),
                  texcoords=s.texcoords[s.face_t].reshape(-1, 2),
                  face_v=idx, face_n=idx.copy(), face_t=idx.copy())
    cent = verts.reshape(T, 3, 3).mean(1) - np.asarray(center, np.float32)
    cent /= np.maximum(np.linalg.norm(cent, axis=-1, keepdims=True), 1e-9)
    amount = push * np.random.default_rng(seed).uniform(0.5, 1.5, (T, 1))
    moved = verts.reshape(T, 3, 3) + (cent * amount)[:, None, :]
    m1 = MeshData(vertices=moved.reshape(-1, 3).astype(np.float32),
                  normals=m0.normals, texcoords=m0.texcoords,
                  face_v=idx.copy(), face_n=idx.copy(), face_t=idx.copy())
    return m0, m1


def ground_grid(half: float, n: int, tiles: float) -> MeshData:
    """A square ground of side 2 half at y = 0, facing up, cut into n x n
    quads whose texture coordinates each run over [0, tiles], so that the
    texture repeats without large coordinates."""
    e = np.linspace(-half, half, n + 1, dtype=np.float32)
    verts, uvs, faces = [], [], []
    for i in range(n):
        for j in range(n):
            b = len(verts)
            verts += [[e[i], 0, e[j + 1]], [e[i + 1], 0, e[j + 1]],
                      [e[i + 1], 0, e[j]], [e[i], 0, e[j]]]
            uvs += [[0, 0], [tiles, 0], [tiles, tiles], [0, tiles]]
            faces += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    fv = np.asarray(faces, np.int32)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.tile(np.float32([[0, 1, 0]]), (len(verts), 1)),
                    texcoords=np.asarray(uvs, np.float32), face_v=fv,
                    face_n=fv.copy(), face_t=fv.copy())


def translated(mesh: MeshData, offset) -> MeshData:
    """A copy of mesh moved by offset (the t = 1 pose of a moving body)."""
    return MeshData(vertices=(mesh.vertices + np.asarray(offset, np.float32)
                              ).astype(np.float32),
                    normals=mesh.normals, texcoords=mesh.texcoords,
                    face_v=mesh.face_v.copy(), face_n=mesh.face_n.copy(),
                    face_t=None if mesh.face_t is None
                    else mesh.face_t.copy())


def cards(centers, normals, ups, width, height) -> MeshData:
    """Textured quads (one per row of centers), each spanning the whole
    texture, facing `normals`, with their v axis along `ups`."""
    c = np.asarray(centers, np.float32)
    n = np.asarray(normals, np.float32)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    up = np.asarray(ups, np.float32)
    up = up - n * np.sum(up * n, -1, keepdims=True)
    up = up / np.maximum(np.linalg.norm(up, axis=-1, keepdims=True), 1e-9)
    side = np.cross(up, n)
    w = np.broadcast_to(np.asarray(width, np.float32), (len(c),))[:, None]
    h = np.broadcast_to(np.asarray(height, np.float32), (len(c),))[:, None]
    corners = [c - side * w / 2, c + side * w / 2,
               c + side * w / 2 + up * h, c - side * w / 2 + up * h]
    K = len(c)
    verts = np.stack(corners, 1).reshape(-1, 3)
    base = 4 * np.arange(K, dtype=np.int32)[:, None]
    faces = np.concatenate([base + np.asarray([[0, 1, 2]]),
                            base + np.asarray([[0, 2, 3]])], 1).reshape(-1, 3)
    uv = np.tile(np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                 (K, 1))
    return MeshData(vertices=verts.astype(np.float32),
                    normals=np.repeat(n, 4, 0).astype(np.float32),
                    texcoords=uv, face_v=faces.astype(np.int32),
                    face_n=faces.astype(np.int32).copy(),
                    face_t=faces.astype(np.int32).copy())


def random_cards(n: int, center, radii, size: float, seed: int,
                 droop: float = 0.0) -> MeshData:
    """n cards of about `size` scattered through an ellipsoid with random
    orientations (a canopy, a tuft of leaves)."""
    rs = np.random.default_rng(seed)
    p = rs.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    p *= rs.uniform(0.55, 1.0, (n, 1)) ** (1 / 3)
    centers = np.asarray(center) + p * np.asarray(radii)
    normals = rs.normal(size=(n, 3))
    ups = p + np.asarray([0.0, -droop, 0.0]) + 0.5 * rs.normal(size=(n, 3))
    s = size * rs.uniform(0.7, 1.3, n)
    return cards(centers, normals, ups, 0.6 * s, s)


def grass_clump(n_blades: int, seed: int) -> MeshData:
    """A clump of thin tapered blades, each a four-triangle strip with
    texture coordinates along the blade."""
    rs = np.random.default_rng(seed)
    verts, faces, uvs, norms = [], [], [], []
    for _ in range(n_blades):
        ang = rs.uniform(0, 2 * np.pi)
        root = np.asarray([rs.uniform(-0.05, 0.05), 0.0,
                           rs.uniform(-0.05, 0.05)])
        side = np.asarray([np.cos(ang), 0.0, np.sin(ang)])
        n = np.cross(side, [0.0, 1.0, 0.0])
        lean = n * rs.uniform(0.02, 0.08)
        hgt = rs.uniform(0.12, 0.25)
        wid = rs.uniform(0.008, 0.015)
        b = len(verts)
        for j, f in enumerate((0.0, 0.5, 1.0)):
            off = root + lean * f * f + np.asarray([0.0, hgt * f, 0.0])
            half = wid * (1 - f) + 1e-3
            verts += [off - side * half, off + side * half]
            uvs += [[0.0, f], [1.0, f]]
            norms += [n, n]
        faces += [[b, b + 1, b + 3], [b, b + 3, b + 2], [b + 2, b + 3, b + 5],
                  [b + 2, b + 5, b + 4]]
    fv = np.asarray(faces, np.int32)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32),
                    texcoords=np.asarray(uvs, np.float32), face_v=fv,
                    face_n=fv.copy(), face_t=fv.copy())
