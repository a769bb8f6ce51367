"""Procedural textures: improved Perlin noise and the Worley stone texture.

Port of raytracer_tpu/shading/procedural.py (PerlinNoise, src/Perlin.h:13-54,
Ken Perlin's improved noise over the standard permutation table; and
StoneTexture, src/StoneTexture.cpp:10-109, F2 - F1 Worley distance
thresholded into stone and grout, modulated by Perlin noise).
`perlin_noise` and `stone_lookup` work on tensors of any shape, on their
device; the bakes rasterize onto `device` (the card unless the caller
names another) and return a tensor there, top row first, ready for
SceneBuilder.add_texture once on the host. The cell centres are drawn on
the host with numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import CUDA, device_of

# Ken Perlin's permutation table (public domain, also src/Perlin.cpp:3-38)
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int64)
_PERM512 = np.concatenate([_PERM, _PERM])

TEX_SIZE = 256  # reference StoneTexture domain (src/StoneTexture.h)

STONE_RGB = (160 / 255.0, 82 / 255.0, 45 / 255.0)   # src/StoneTexture.cpp:11-13
GROUT_RGB = (250 / 255.0, 235 / 255.0, 215 / 255.0)  # src/StoneTexture.cpp:16-18


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Gradient dot product (src/Perlin.h:45-51), branchless."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where(h & 1 == 0, u, -u) + torch.where(h & 2 == 0, v, -v)


def _lerp(t, a, b):
    return a + t * (b - a)


def perlin_noise(x, y, z) -> torch.Tensor:
    """Improved Perlin noise of float32 tensors (or numbers) of one
    broadcast shape, on their device (src/Perlin.h:16-40)."""
    x, y, z = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.float32) for c in (x, y, z)))
    p = torch.as_tensor(_PERM512, device=x.device)
    xf, yf, zf = torch.floor(x), torch.floor(y), torch.floor(z)
    X = xf.to(torch.int64) & 255
    Y = yf.to(torch.int64) & 255
    Z = zf.to(torch.int64) & 255
    x, y, z = x - xf, y - yf, z - zf
    u, v, w = _fade(x), _fade(y), _fade(z)
    A = p[X] + Y
    AA = p[A] + Z
    AB = p[A + 1] + Z
    B = p[X + 1] + Y
    BA = p[B] + Z
    BB = p[B + 1] + Z
    return _lerp(w,
                 _lerp(v,
                       _lerp(u, _grad(p[AA], x, y, z),
                             _grad(p[BA], x - 1, y, z)),
                       _lerp(u, _grad(p[AB], x, y - 1, z),
                             _grad(p[BB], x - 1, y - 1, z))),
                 _lerp(v,
                       _lerp(u, _grad(p[AA + 1], x, y, z - 1),
                             _grad(p[BA + 1], x - 1, y, z - 1)),
                       _lerp(u, _grad(p[AB + 1], x, y - 1, z - 1),
                             _grad(p[BB + 1], x - 1, y - 1, z - 1))))


def make_stone_cells(num_cells: int = 100, seed: int = 3163513):
    """Random Worley cell centres in the 256^2 domain and the F2 - F1
    normalisation bounds (src/StoneTexture.cpp:20-53) -> (numpy (C, 2)
    float32 centres, min, max). The reference draws with libc rand(); a
    fixed-seed numpy generator stands in, as in the JAX package."""
    rs = np.random.default_rng(seed)
    pts = rs.integers(0, TEX_SIZE, size=(num_cells, 2)).astype(np.float32)
    w = np.arange(TEX_SIZE, dtype=np.float32)
    gx, gy = np.meshgrid(w, w, indexing='ij')
    d2 = (pts[:, 0][:, None, None] - gx) ** 2 \
        + (pts[:, 1][:, None, None] - gy) ** 2   # (C, S, S)
    part = np.partition(d2, 1, axis=0)
    f21 = np.sqrt(part[1]) - np.sqrt(part[0])
    return pts, float(f21.min()), float(f21.max())


def stone_lookup(u, v, cells, min_d: float, max_d: float,
                 num_cells: int = 100) -> torch.Tensor:
    """Worley F2 - F1 stone and grout colour (src/StoneTexture.cpp:61-104)
    of texture coords u, v (tensors of one shape), with cell centres
    `cells` (C, 2) on their device -> u's shape + (3,)."""
    u = u - torch.trunc(u)
    v = v - torch.trunc(v)
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.where(v < 0, v + 1.0, v)
    v = 1.0 - v
    px = u * TEX_SIZE
    py = v * TEX_SIZE
    d2 = (cells[:, 0] - px[..., None]) ** 2 \
        + (cells[:, 1] - py[..., None]) ** 2
    # F1, its cell and F2 without a sort: two minimum passes
    f1, cell = torch.min(d2, dim=-1)
    f2 = torch.where(d2 == f1[..., None], torch.inf, d2).amin(-1)
    fd = torch.sqrt(f2) - torch.sqrt(f1)
    mask = torch.where((fd - min_d) / (max_d - min_d) > 0.05, 1.0, 0.0)
    one = torch.ones_like(px)
    # each cell's noise coordinate 255 c / num_cells, divided in numpy: the
    # card divides a tensor by a number as a product with its reciprocal,
    # which is an ulp off, and at 255 an ulp moves the noise by 1e-5
    cell_x = torch.from_numpy(np.arange(num_cells, dtype=np.float32)
                              * np.float32(255.0) / np.float32(num_cells))
    cn = 0.5 * perlin_noise(cell_x.to(u.device)[cell], one, one)
    grout = 0.5 + 0.5 * perlin_noise(255.0 * u, 255.0 * v, one)
    sn = 0.05 * perlin_noise(64.0 * u, 64.0 * v, one)
    st = torch.tensor(STONE_RGB, dtype=torch.float32, device=u.device)
    gr = torch.tensor(GROUT_RGB, dtype=torch.float32, device=u.device)
    cmod = torch.stack([cn, cn * 0.2, cn * 0.1], -1)
    return sn[..., None] + (st + cmod) * mask[..., None] \
        + gr * ((1.0 - mask) * grout)[..., None]


def bake_stone_texture(num_cells: int = 100, size: int = 512,
                       seed: int = 3163513, device=CUDA) -> torch.Tensor:
    """Rasterize the stone texture -> (size, size, 3) float32 on `device`,
    top row first: texel centres in uv, rows from v = 1 down to 0, since
    lookups flip v."""
    dev = device_of(device)
    cells, mn, mx = make_stone_cells(num_cells, seed)
    us = (np.arange(size) + 0.5) / size
    vs = 1.0 - (np.arange(size) + 0.5) / size
    uu, vv = np.meshgrid(us, vs, indexing='xy')
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return stone_lookup(f(uu), f(vv), f(cells), mn, mx, num_cells)


def bake_perlin_texture(size: int = 512, scale: float = 8.0, z: float = 0.5,
                        device=CUDA) -> torch.Tensor:
    """Greyscale Perlin bitmap in [0, 1] -> (size, size, 1) float32 on
    `device`."""
    dev = device_of(device)
    us = (np.arange(size) + 0.5) / size * scale
    uu, vv = np.meshgrid(us, us, indexing='xy')
    uu = torch.as_tensor(np.asarray(uu, np.float32), device=dev)
    vv = torch.as_tensor(np.asarray(vv, np.float32), device=dev)
    img = 0.5 + 0.5 * perlin_noise(uu, vv, torch.full_like(uu, z))
    return img[..., None]
