"""Texture sampling from the flat texel pool.

Port of raytracer_tpu/shading/textures.py (Texture::getLookup and
friends, src/Texture.cpp:12-125): wrap to [0,1), flip v, bilinear filter
with tiled pixel fetch, lat-long env mapping. An empty pool (a textureless
scene) short-circuits every lookup to rgb 0 / alpha 1 without a gather, and
`TexBatch` fuses one bounce's lookups into one pool gather.
"""
from __future__ import annotations

import torch

from ..core.types import TexturePack
from ..core.vecmath import PI, INV_PI, take


def _wrap_uv(u, v):
    u = u - torch.trunc(u)
    v = v - torch.trunc(v)
    u = torch.where(u < 0, u + 1.0, u)
    v = torch.where(v < 0, v + 1.0, v)
    return u, 1.0 - v  # v flip (src/Texture.cpp:53-54)


def _no_texture_rgba(u):
    z = torch.zeros(tuple(u.shape) + (4,), dtype=torch.float32,
                    device=u.device)
    z[..., 3] = 1.0
    return z


def _lookup_plan(tp: TexturePack, tex_id, u, v):
    """Pool indices (..., 16) of one bilinear RGBA lookup (4 corners x 4
    channels) and the lerp state (dx, dy, c)."""
    tid = torch.clamp(tex_id, min=0).long()
    off = tp.offset[tid]
    w = tp.width[tid]
    h = tp.height[tid]
    c = tp.channels[tid]
    u, v = _wrap_uv(u, v)
    px = u * w
    py = v * h
    x1 = torch.floor(px)
    y1 = torch.floor(py)
    dx = (px - x1)[..., None]
    dy = (py - y1)[..., None]
    x1 = x1.to(torch.int32)
    y1 = y1.to(torch.int32)
    n = tp.data.shape[0]
    k = torch.arange(4, dtype=torch.int32, device=u.device)
    kc = torch.minimum(k, c[..., None] - 1)
    idxs = []
    for cx, cy in ((x1, y1), (x1 + 1, y1), (x1, y1 + 1), (x1 + 1, y1 + 1)):
        x = torch.remainder(cx, w)
        y = torch.remainder(cy, h)
        base = off + (y * w + x) * c
        idxs.append(torch.clamp(base[..., None] + kc, 0, n - 1))
    return torch.cat(idxs, dim=-1).long(), (dx, dy, c)


def _lookup_combine(vals16, state):
    """Bilinear-combine the 16 gathered pool values -> RGBA (..., 4)."""
    dx, dy, c = state

    def pix(v4):
        gray = c[..., None] == 1
        rgb = torch.where(gray, v4[..., 0:1], v4[..., :3])
        alpha = torch.where(c >= 4, v4[..., 3], torch.ones_like(v4[..., 3]))
        return torch.cat([rgb, alpha[..., None]], dim=-1)

    q11 = pix(vals16[..., 0:4])
    q21 = pix(vals16[..., 4:8])
    q12 = pix(vals16[..., 8:12])
    q22 = pix(vals16[..., 12:16])
    q1 = q11 * (1.0 - dx) + q21 * dx
    q2 = q12 * (1.0 - dx) + q22 * dx
    return q1 * (1.0 - dy) + q2 * dy


def tex_lookup(tp: TexturePack, tex_id, u, v):
    """Bilinear RGBA lookup -> (..., 4); tex_id < 0 is clamped to 0 and
    callers mask the result."""
    if tp.data.shape[0] == 0:
        return _no_texture_rgba(u)
    idx, state = _lookup_plan(tp, tex_id, u, v)
    return _lookup_combine(take(tp.data, idx, 'tex'), state)


def tex_lookup_batch(tp: TexturePack, queries):
    """Many lookups [(tex_id, u, v), ...], one pool gather -> RGBA list."""
    if tp.data.shape[0] == 0:
        return [_no_texture_rgba(u) for (_, u, _) in queries]
    plans = [_lookup_plan(tp, t, u, v) for (t, u, v) in queries]
    vals = take(tp.data, torch.cat([p[0] for p in plans], dim=-1), 'tex')
    return [_lookup_combine(vals[..., 16 * i:16 * (i + 1)], p[1])
            for i, p in enumerate(plans)]


def tex_lookup3(tp: TexturePack, tex_id, u, v):
    return tex_lookup(tp, tex_id, u, v)[..., :3]


def tex_lookup_alpha(tp: TexturePack, tex_id, u, v):
    return tex_lookup(tp, tex_id, u, v)[..., 3]


def env_uv(direction):
    """Lat-long mapping (src/Texture.cpp:90-98)."""
    d = direction
    theta = torch.atan2(d[..., 2], d[..., 0]) + PI
    phi = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return theta * 0.5 * INV_PI, 1.0 - phi * INV_PI


def env_lookup(tp: TexturePack, tex_id, direction):
    """Lat-long environment lookup -> (..., 3)."""
    u, v = env_uv(direction)
    return tex_lookup3(tp, tex_id, u, v)


class TexBatch:
    """Collect bilinear lookups and run them as ONE pool gather:
    i = batch.add(tex_id, u, v); batch.run(); batch.get(i) -> RGBA."""

    def __init__(self, tp: TexturePack):
        self.tp = tp
        self.queries = []
        self.vals = None

    def add(self, tex_id, u, v) -> int:
        self.queries.append((tex_id, u, v))
        return len(self.queries) - 1

    def run(self) -> None:
        if self.queries:
            self.vals = tex_lookup_batch(self.tp, self.queries)

    def get(self, i: int):
        return self.vals[i]
