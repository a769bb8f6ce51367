"""The brute-force Moller-Trumbore sweep in plain PyTorch: the reference
for the CUDA kernel csrc/mt_trace.cu.

Port of raytracer_tpu/ops/pallas/mt_kernel.py (`_mt_block`, `_kernel`,
`mt_trace_pallas`): every ray against every triangle, with the Pallas
kernel's rule, so the three agree hit for hit:
  * triangles are swept in id order, a tile of TRI_TILE at a time; inside a
    tile the hit of smallest t wins, the first (lowest id) lane on equal t;
  * a tile's hit replaces the running best only with a strictly smaller t
    (each tile tests t < min(tmax, best_t)), so an exact tie anywhere goes
    to the lowest triangle id, whatever the tile width;
  * a triangle hits when det != 0, 0 <= a, 0 <= b, a <= 1, a + b <= 1,
    tmin <= t < tmax and its `valid` flag is set (padding lanes are not);
  * a miss returns t = MIRO_TMAX, tri = -1 and a = b = 0.
`_mt_block` keeps the Pallas arithmetic term for term (e0 = p1 - p0,
inv_det = 1 / det, a = dot(tvec, pvec) * inv_det, each dot summed x, y,
z), so the kernel, built with -fmad=false, matches this version bit for
bit. Triangles are processed TRI_TILE at a time, so memory stays at a few
(R, TRI_TILE) buffers.
"""
from __future__ import annotations

import torch

from ..core.vecmath import MIRO_TMAX

TRI_TILE = 512
BIG = 3.0e38       # the Pallas kernel's running-best start (_BIG)

# number of calls of the plain version, so a run can show which path it took
CALLS = 0


def _mt_block(o, d, p0, p1, p2, tmin, tmax):
    """Moller-Trumbore on an (R, T) block in the Pallas order. o, d: three
    (R, 1) components each; p0, p1, p2: three (1, T) components each;
    tmin, tmax (R, 1) -> (t, a, b, ok), each (R, T)."""
    ox, oy, oz = o
    dx, dy, dz = d
    e0x = p1[0] - p0[0]
    e0y = p1[1] - p0[1]
    e0z = p1[2] - p0[2]
    e1x = p2[0] - p0[0]
    e1y = p2[1] - p0[1]
    e1z = p2[2] - p0[2]
    pvx = dy * e1z - dz * e1y
    pvy = dz * e1x - dx * e1z
    pvz = dx * e1y - dy * e1x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    inv_det = 1.0 / det                       # inf on det == 0; rejected
    tvx = ox - p0[0]
    tvy = oy - p0[1]
    tvz = oz - p0[2]
    a = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    b = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e1x * qvx + e1y * qvy + e1z * qvz) * inv_det
    ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) \
        & (det != 0.0) & (t >= tmin) & (t < tmax)
    return t, a, b, ok


def per_ray(x, o):
    """A scalar or (R,) bound as a contiguous detached (R,) float32 tensor
    on o's device."""
    x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
    return x.detach().expand(o.shape[0]).contiguous()


@torch.no_grad()
def mt_trace(o, d, p0, p1, p2, valid, tmin, tmax, tile: int = TRI_TILE):
    """All-pairs nearest hit of rays o, d (R, 3) against triangles with
    corners p0, p1, p2 (T, 3); valid (T,) marks real triangles; tmin and
    tmax are scalars or (R,) -> (t, tri, a, b), each (R,)."""
    global CALLS
    CALLS += 1
    R, T = o.shape[0], p0.shape[0]
    dev = o.device
    f32 = torch.float32
    o, d = o.detach().to(f32), d.detach().to(f32)
    p0, p1, p2 = (p.detach().to(f32) for p in (p0, p1, p2))
    valid = valid.to(device=dev) > 0
    tmin = per_ray(tmin, o)[:, None]
    tmax = per_ray(tmax, o)[:, None]
    oc = (o[:, 0:1], o[:, 1:2], o[:, 2:3])
    dc = (d[:, 0:1], d[:, 1:2], d[:, 2:3])
    best_t = torch.full((R,), BIG, dtype=f32, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_a = torch.zeros(R, dtype=f32, device=dev)
    best_b = torch.zeros(R, dtype=f32, device=dev)
    rows = torch.arange(R, device=dev)
    for j0 in range(0, T, tile):
        sl = slice(j0, min(j0 + tile, T))
        comps = [tuple(p[sl, k][None] for k in range(3))
                 for p in (p0, p1, p2)]
        t, a, b, ok = _mt_block(oc, dc, *comps, tmin,
                                torch.minimum(tmax, best_t[:, None]))
        ok = ok & valid[sl][None]
        t = torch.where(ok, t, BIG)
        best = t.amin(dim=1)
        # the first lane at the minimum
        lane = torch.arange(t.shape[1], device=dev)
        sel = torch.where(t <= best[:, None], lane, t.shape[1]).amin(dim=1)
        sel = sel.clamp(max=t.shape[1] - 1)
        found = best < best_t
        best_t = torch.where(found, best, best_t)
        best_tri = torch.where(found, (j0 + sel).to(torch.int32), best_tri)
        best_a = torch.where(found, a[rows, sel], best_a)
        best_b = torch.where(found, b[rows, sel], best_b)
    miss = best_tri < 0
    return (torch.where(miss, MIRO_TMAX, best_t), best_tri, best_a, best_b)

