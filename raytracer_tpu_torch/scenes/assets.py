"""Procedural stand-ins for the model and image files that the registry's
asset scenes read, and that the repository does not ship: meshes as
MeshData and images as float32 (H, W, C) arrays, top row first, each made
with numpy from a fixed seed. Nothing here reads a file.

`write_tree(root)` writes every one of those files under the reference
checkout's layout (Models/, Models/CornellBox/, Models/Final/, Textures/,
Images/): OBJ text, uncompressed TGA (type 2; 32-bit where a scene uses the
image as an alpha map) and flat Radiance RGBE, so that the asset scenes
build and render from it when RT_ASSETS names it. It is a test and smoke
tool: what it writes looks nothing like the reference's models.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..geometry import shapes
from ..io.objload import MeshData

# rows of the procedural dome skies: odd, so that no dome sample direction
# (taken at row floor(v) of the table, theta = row pi / rows) is exactly
# horizontal; such a sample grazes a ground plane at y = 0, and whether its
# shadow ray hits the ground then rests on the last bit of the hit point
DOME_ROWS = 127


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


def petal_ring(y: float, r: float, n: int, size: float) -> MeshData:
    """n petal cards in a ring of radius r / 2 at height y, tilted up and
    out."""
    ang = np.arange(n) * 2 * np.pi / n
    ring = np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], -1)
    return cards((0.0, y, 0.0) + ring * r * 0.5,
                 ring + np.asarray([0.0, 1.5, 0.0]), ring, 0.6 * size, size)


def _wall(origin, eu, ev, with_uv: bool = False) -> MeshData:
    """The quad origin, + eu, + eu + ev, + ev, facing eu x ev."""
    o, eu, ev = (np.asarray(x, np.float32) for x in (origin, eu, ev))
    return shapes.quad(o, o + eu, o + eu + ev, o + ev, with_uv=with_uv)


def merged(meshes) -> MeshData:
    """One mesh of several (all with texture coordinates, or none)."""
    meshes = list(meshes)
    uv = meshes[0].texcoords is not None
    off = lambda key: np.cumsum([0] + [len(getattr(m, key))
                                       for m in meshes[:-1]])
    ov, on = off('vertices'), off('normals')
    ot = off('texcoords') if uv else None
    cat = lambda key, o: np.concatenate(
        [getattr(m, key) + o[i] for i, m in enumerate(meshes)]).astype(
            np.int32)
    return MeshData(
        vertices=np.concatenate([m.vertices for m in meshes]).astype(
            np.float32),
        normals=np.concatenate([m.normals for m in meshes]).astype(
            np.float32),
        texcoords=np.concatenate([m.texcoords for m in meshes]).astype(
            np.float32) if uv else None,
        face_v=cat('face_v', ov), face_n=cat('face_n', on),
        face_t=cat('face_t', ot) if uv else None)


# the Cornell boxes' room: x in [0, W], z in [-D, 0], the ceiling at H,
# above the scenes' rect light (at y = 5.5, x and z in 2.5-3 and -3 to
# -2.5); the emitter quad sits LIGHT_DROP below the light, closer than the
# shadow rays' stand-off, under the light's own extent
CORNELL_W, CORNELL_D, CORNELL_H = 5.5, 5.5, 5.6
LIGHT_Y, LIGHT_DROP = 5.5, 1e-5


def _cornell_room(blocks: bool) -> dict:
    """The Cornell room as its four files' meshes: 'light' (the emitter
    quad, facing down), 'white' (floor, ceiling, back wall, and with
    `blocks` a short and a tall block), 'red' (left wall), 'green' (right
    wall), every wall facing in."""
    W, D, H = CORNELL_W, CORNELL_D, CORNELL_H
    white = [_wall((0, 0, 0), (W, 0, 0), (0, 0, -D)),           # floor
             _wall((0, H, 0), (0, 0, -D), (W, 0, 0)),           # ceiling
             _wall((0, 0, -D), (W, 0, 0), (0, H, 0))]           # back
    if blocks:
        white += [shapes.box((3.2, 0, -2.2), (4.6, 1.6, -0.8)),
                  shapes.box((0.9, 0, -4.4), (2.3, 3.3, -3.0))]
    y = LIGHT_Y - LIGHT_DROP
    return dict(light=_wall((2.5, y, -2.5), (0, 0, -0.5), (0.5, 0, 0)),
                white=merged(white),
                red=_wall((0, 0, 0), (0, 0, -D), (0, H, 0)),
                green=_wall((W, 0, 0), (0, H, 0), (0, 0, -D)))


def write_obj(path: str, mesh: MeshData) -> None:
    """A mesh as an OBJ file: every vertex, normal and texture coordinate
    at 9 significant digits (a float32 reads back exactly), and each
    triangle's v/t/n or v//n corners."""
    rows = ['v %.9g %.9g %.9g' % tuple(p) for p in mesh.vertices.tolist()]
    rows += ['vn %.9g %.9g %.9g' % tuple(n) for n in mesh.normals.tolist()]
    fv, fn = mesh.face_v + 1, mesh.face_n + 1
    if mesh.texcoords is not None:
        rows += ['vt %.9g %.9g' % tuple(t) for t in mesh.texcoords.tolist()]
        ft = mesh.face_t + 1
        rows += ['f ' + ' '.join(f'{v}/{t}/{n}' for v, t, n in zip(*c))
                 for c in zip(fv.tolist(), ft.tolist(), fn.tolist())]
    else:
        rows += ['f ' + ' '.join(f'{v}//{n}' for v, n in zip(*c))
                 for c in zip(fv.tolist(), fn.tolist())]
    with open(path, 'w') as f:
        f.write('\n'.join(rows) + '\n')


def _write_tga(path: str, img: np.ndarray) -> None:
    """(H, W, 3 or 4) linear floats, top row first, as an uncompressed
    true-colour TGA (type 2), bottom row first in the file as the
    reference's textures are: colour gamma-encoded (io/imageio's LUT
    inverted, to the nearest byte), alpha linear, channels BGR(A)."""
    h, w, c = img.shape
    x = np.clip(img, 0.0, 1.0)
    x = np.concatenate([x[..., :3] ** (1 / 2.2), x[..., 3:]], -1)
    px = np.floor(x * 255.0 + 0.5).astype(np.uint8)
    px = px[::-1][..., [2, 1, 0] + ([3] if c == 4 else [])]
    header = struct.pack('<BBBHHBHHHHBB', 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                         8 * c, 8 if c == 4 else 0)
    with open(path, 'wb') as f:
        f.write(header + np.ascontiguousarray(px).tobytes())


def _write_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) floats, top row first, as a flat (unencoded) Radiance RGBE
    file. The largest channel's mantissa byte is at least 128, so no pixel
    reads as a run-length marker."""
    h, w, _ = img.shape
    rgb = np.maximum(np.asarray(img, np.float64), 0.0)
    top = rgb.max(-1)
    m, e = np.frexp(top)
    live = top > 1e-32
    scale = np.where(live, 256.0 / np.ldexp(1.0, e), 0.0)
    px = np.zeros((h, w, 4), np.uint8)
    px[..., :3] = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    px[..., 3] = np.where(live, e + 128, 0).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n')
        f.write(b'-Y %d +X %d\n' % (h, w))
        f.write(px.tobytes())


# the procedural trunks' heights in the JAX registry's final_forest (its
# _procedural_trunk defaults and its second tree), which size the canopies
# of the stand-in leaf files; leaf cards per canopy
FOREST_TRUNKS = (1.2, 1.5)
LEAF_CARDS = 1500


def _canopy(h: float, seed: int) -> MeshData:
    return random_cards(LEAF_CARDS, (0.0, 0.85 * h, 0.0),
                        (0.45 * h, 0.3 * h, 0.45 * h), 0.08 * h, seed=seed,
                        droop=0.5)


def _models() -> dict:
    """Models/: relative path -> the stand-in mesh."""
    out = {}
    for name, mesh in _cornell_room(blocks=True).items():
        out[f'cornell_box-{name}.obj'] = mesh
    for name, mesh in _cornell_room(blocks=False).items():
        out[f'CornellBox/Box_{name}.obj'] = mesh
    out['CornellBox/Sphere_Glass.obj'] = shapes.uv_sphere((1.7, 1.0, -3.4),
                                                          1.0, 16, 32)
    out['CornellBox/Sphere_Metal.obj'] = shapes.uv_sphere((3.9, 1.0, -1.9),
                                                          1.0, 16, 32)
    # the teapot: a 576-triangle sphere resting on y = 0 (as sponza_standin's
    # clutter), with texture coordinates for sponza_proxy's tangents
    out['teapot.obj'] = shapes.uv_sphere((0.0, 1.0, 0.0), 1.0, 13, 24)
    out['bulletMB_01.obj'], out['bulletMB_02.obj'] = shattered_sphere(
        (0.0, 0.0, 0.0), 1.0, 8, 16, 0.6, 11)
    y = 10.0 - LIGHT_DROP             # under sponza_proxy's rect light
    out['sponza-light.obj'] = _wall((-8, y, -2), (0, 0, 4), (16, 0, 0))
    out['leaf_test.obj'] = _wall((-1, -1, 0), (2, 0, 0), (0, 2, 0),
                                 with_uv=True)
    out['sphere2.obj'] = shapes.uv_sphere((0.0, 2.0, 0.0), 1.0, 24, 48)
    out['testGrass.obj'] = grass_clump(12, seed=72)
    F = 'Final/'
    out[F + 'groundPlane.obj'] = ground_grid(1000.0, 20, 20.0)
    out[F + 'explosion01.obj'], out[F + 'explosion02.obj'] = \
        shattered_sphere((0.35, 0.45, 0.4), 0.12, 8, 12, 0.1, 22)
    ball = shapes.uv_sphere((0.05, 0.4, 0.7), 0.05, 10, 16)
    out[F + 'cannonBallT1.obj'] = ball
    out[F + 'cannonBallT2.obj'] = translated(ball, (0.25, 0.0, 0.0))
    for k, (name, h) in enumerate(zip(('tree02', 'tree03'),
                                      FOREST_TRUNKS)):
        out[F + f'{name}Leaves.obj'] = _canopy(h, 40 + k)
    out[F + 'flower02Body.obj'] = shapes.cylinder((0, 0, 0), 0.008, 0.35,
                                                  n_seg=6)
    out[F + 'flower02Bulb.obj'] = shapes.uv_sphere((0, 0.37, 0), 0.025, 6,
                                                   10)
    out[F + 'flower02Leaves.obj'] = random_cards(
        6, (0, 0.12, 0), (0.06, 0.08, 0.06), 0.08, seed=62)
    out[F + 'flower02Petals.obj'] = petal_ring(0.37, 0.05, 8, 0.06)
    out[F + 'flower01BigLeaves.obj'] = random_cards(
        8, (0, 0.08, 0), (0.1, 0.06, 0.1), 0.12, seed=64, droop=1.0)
    out[F + 'flower01Body.obj'] = shapes.cylinder((0, 0, 0), 0.006, 0.3,
                                                  n_seg=6)
    for k, c in enumerate(((0.0, 0.31, 0.0), (0.03, 0.27, 0.01),
                           (-0.02, 0.25, -0.02))):
        out[F + f'flower01Bulbs0{k + 1}.obj'] = shapes.uv_sphere(c, 0.015,
                                                                5, 8)
    out[F + 'flower01Petals.obj'] = petal_ring(0.31, 0.04, 10, 0.05)
    out[F + 'flower01Pistils.obj'] = shapes.cylinder((0, 0.3, 0), 0.002,
                                                     0.03, n_seg=4)
    out[F + 'flower01SmallLeaves.obj'] = random_cards(
        10, (0, 0.18, 0), (0.05, 0.05, 0.05), 0.05, seed=66)
    return {'Models/' + k: v for k, v in out.items()}


def _images() -> dict:
    """Textures/ and Images/: relative path -> the stand-in image (RGBA
    where a scene uses it as an alpha map)."""
    sky = sky_hdr(DOME_ROWS, 256)
    T = 'Textures/'
    return {
        T + 'sky.hdr': sky,
        'Images/sky.hdr': sky,
        'Images/Topanga_Forest_B_light.hdr': sky_hdr(64, 128,
                                                     sun_power=40.0),
        T + 'hdrvfx_nyany_1_n2_v101_Ref.hdr': sky_hdr(
            128, 256, sun_u=0.7, sun_el=20.0, sun_power=60.0,
            zenith=(0.3, 0.35, 0.6)),
        T + 'grass-color-01.tga': solid_texture((0.2, 0.45, 0.1), 64,
                                                grain=0.4, seed=5),
        T + 'Tree_03_Leaves.tga': leaf_texture(128, seed=3),
        T + 'ground-dirt-texture.tga': solid_texture((0.35, 0.25, 0.15), 128,
                                                     grain=0.5, seed=21),
        T + 'bw2.tga': checker_texture(),
        T + 'AL04brk.tga': solid_texture((0.3, 0.22, 0.15), 64, seed=31),
        T + 'AL04aut.tga': leaf_texture(128, (0.6, 0.3, 0.08), seed=32),
        T + 'AL17brk.tga': solid_texture((0.25, 0.2, 0.16), 64, seed=33),
        T + 'AL17aut.tga': leaf_texture(128, (0.55, 0.45, 0.1), seed=34),
        T + 'bud-yellow-1.tga': solid_texture((0.9, 0.8, 0.2), seed=51),
        # a tangent-space normal map, stored as 0.5 + 0.5 n as such files are
        T + 'bud-yellow-1-bump_NRM.tga': 0.5 + 0.5 * normal_map(seed=52),
        T + 'grass-color-23.tga': solid_texture((0.2, 0.5, 0.15), seed=53),
        T + 'grass-color-18.tga': solid_texture((0.25, 0.55, 0.2), seed=54),
        T + 'petal-pink-02.tga': solid_texture((0.95, 0.5, 0.6), seed=55),
        T + 'FL30lef1.tga': leaf_texture(64, (0.2, 0.5, 0.15), seed=56),
        T + 'FL30stm1.tga': solid_texture((0.3, 0.5, 0.2), seed=57),
        T + 'FL30flo1.tga': solid_texture((0.8, 0.3, 0.5), seed=58),
        T + 'FL30pet1.tga': solid_texture((0.9, 0.6, 0.8), seed=59),
        T + 'FL30stm2.tga': solid_texture((0.9, 0.85, 0.4), seed=60),
        T + 'FL30lef2.tga': leaf_texture(64, (0.25, 0.55, 0.2), seed=61),
        T + 'grassblade2.tga': solid_texture((0.3, 0.6, 0.15), 16, grain=0.3,
                                             seed=71)}


def write_tree(root: str) -> list[str]:
    """Write every file that the registry's asset scenes read under `root`,
    in the reference checkout's layout -> their paths relative to root."""
    written = []
    for rel, data in [*_models().items(), *_images().items()]:
        path = os.path.join(root, *rel.split('/'))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if rel.endswith('.obj'):
            write_obj(path, data)
        elif rel.endswith('.tga'):
            _write_tga(path, data)
        else:
            _write_hdr(path, data)
        written.append(rel)
    return written
