"""Conservative per-ray-block frustum culling, in plain PyTorch.

Port of raytracer_tpu/ops/pallas/bundle.py. Rays are laid out as
(nb, 9, RB) blocks (rows o, d, tmin, tmax, time). `make_block_culler`
bounds each block's live rays by an interval hull (origin interval,
inverse-direction interval) and tests one AABB against every hull;
`disable_blocks` sets tmax = -1 on the blocks that cannot reach it, which
every tracer then skips. The test is conservative: interval arithmetic
over-approximates the bundle, and rounding is monotone, so a block is never
culled from a box that one of its rays passes the slab test of.

`group_levels` builds the union boxes that the trace kernels and their
plain versions walk in place of a flat scan of a box table;
`cached_levels` keeps them for the kernels' wrappers while the boxes stay
the same.
"""
from __future__ import annotations

import weakref

import torch

from ..geometry.clusters import NEVER

BIG = 3e38
# per kind of box table: (the box tensors' ids and versions, weak references
# to them, their group levels)
_levels: dict = {}


def ray_blocks(o, d, tmin, tmax, rb: int):
    """(R, 3) o, d and (R,) tmin, tmax -> (nb, 9, rb) blocks; padding rays
    carry tmax = -1."""
    R = o.shape[0]
    pad = (-R) % rb
    rows = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tmin, tmax,
            torch.zeros_like(tmin)]
    fill = [0.0] * 7 + [-1.0, 0.0]
    rows = [torch.nn.functional.pad(x, (0, pad), value=f)
            for x, f in zip(rows, fill)]
    return torch.stack(rows).reshape(9, -1, rb).transpose(0, 1)


def box_union(bb6, real=None):
    """(lo (3,), hi (3,)) union of the lane boxes bb6 (6, L).

    Lane padding carries never-hit boxes with lo = hi = +3e37, which would
    corrupt a plain max over the hi rows; `real` (L,) bool masks them
    (default: lo.x < 1e37)."""
    if real is None:
        real = bb6[0] < 1e37
    lo = torch.where(real, bb6[0:3], BIG).amin(dim=1)
    hi = torch.where(real, bb6[3:6], -BIG).amax(dim=1)
    return lo, hi


def group_boxes(bb6, g: int):
    """(..., 6, L) boxes -> (..., 6, ceil(L / g)) unions of g consecutive
    real boxes (table order); a group of padding lanes only is a never-hit
    point box."""
    bb = torch.nn.functional.pad(bb6, (0, (-bb6.shape[-1]) % g), value=NEVER)
    real = (bb[..., 0, :] < 1e37)[..., None, :]
    lo = torch.where(real, bb[..., :3, :], torch.inf).unflatten(-1, (-1, g))
    hi = torch.where(real, bb[..., 3:, :], -torch.inf).unflatten(-1, (-1, g))
    some = real.unflatten(-1, (-1, g)).any(-1)
    return torch.where(some, torch.cat([lo.amin(-1), hi.amax(-1)], -2),
                       NEVER).contiguous()


def group_levels(bb6, g: int, depth: int) -> list:
    """The `depth` group levels of the trace kernels' walks over a (..., 6,
    L) box table: level 1 unions g consecutive boxes, level k + 1 g
    consecutive groups of level k. A union box's entry key is never larger
    than a member's (float rounding is monotone), so a walk that skips a
    group whose key does not beat the ray's best t drops only members the
    flat scan would drop too."""
    levels = []
    for _ in range(depth):
        bb6 = group_boxes(bb6, g)
        levels.append(bb6)
    return levels


def cached_levels(kind: str, boxes: tuple, make):
    """make() -> the group levels of the box tensors `boxes`, built once
    and kept while each is the same tensor at the same version: a frame's
    launches share them, and the trainer's table refresh makes new
    tensors every step. (Built anew on each launch, their thirty-odd small
    operations cost the host about a millisecond a launch.) One slot per
    `kind`: two tables of one kind in turn rebuild each other's levels."""
    stamp = tuple((id(x), x._version) for x in boxes)
    hit = _levels.get(kind)
    if hit is not None and hit[0] == stamp and all(
            r() is x for r, x in zip(hit[1], boxes)):
        return hit[2]
    levels = make()
    _levels[kind] = (stamp, tuple(weakref.ref(x) for x in boxes), levels)
    return levels


def make_block_culler(rays):
    """rays (nb, 9, RB) -> enabled(lo, hi) -> (nb,) bool: can any live ray
    of each block hit the box [lo, hi] within its [tmin, tmax]?"""
    live = rays[:, 7, :] > 0.0                            # (nb, RB)
    live3 = live[:, None, :]

    def mn(v, m):
        return torch.where(m, v, BIG).amin(dim=-1)

    def mx(v, m):
        return torch.where(m, v, -BIG).amax(dim=-1)

    olo, ohi = mn(rays[:, 0:3], live3), mx(rays[:, 0:3], live3)   # (nb, 3)
    dlo, dhi = mn(rays[:, 3:6], live3), mx(rays[:, 3:6], live3)
    tmin_lo = mn(rays[:, 6], live)                        # (nb,)
    tmax_hi = mx(rays[:, 7], live)
    any_live = live.any(dim=-1)
    # inverse-direction interval per axis; a direction interval that
    # straddles zero gives an unbounded one, and the slab test then passes
    eps = 1e-12
    pos, neg = dlo > eps, dhi < -eps
    one = torch.ones_like(dlo)
    inv_a = torch.where(pos, 1.0 / torch.where(pos, dhi, one),
                        torch.where(neg, 1.0 / torch.where(neg, dlo, one),
                                    -BIG))
    inv_b = torch.where(pos, 1.0 / torch.where(pos, dlo, one),
                        torch.where(neg, 1.0 / torch.where(neg, dhi, one),
                                    BIG))

    def enabled(lo, hi):
        ax_lo = ax_hi = None
        for s in (lo[None] - ohi, lo[None] - olo, hi[None] - ohi,
                  hi[None] - olo):
            for h in (s * inv_a, s * inv_b):
                ax_lo = h if ax_lo is None else torch.minimum(ax_lo, h)
                ax_hi = h if ax_hi is None else torch.maximum(ax_hi, h)
        t0 = ax_lo.amax(dim=1)                            # (nb,)
        t1 = ax_hi.amin(dim=1)
        return any_live & (t1 >= t0) & (t1 >= tmin_lo) & (t0 <= tmax_hi)

    return enabled


def disable_blocks(rays, enabled):
    """rays with tmax = -1 on the blocks where `enabled` is False."""
    rays = rays.clone()
    rays[:, 7, :] = torch.where(enabled[:, None], rays[:, 7, :], -1.0)
    return rays


def cull_tmax(o, d, tmin, tmax, bb6, rb: int = 32):
    """tmax with -1 on every ray of the rb-ray blocks (in ray order) that
    cannot reach the union of the lane boxes bb6 (6, L)."""
    R = o.shape[0]
    enabled = make_block_culler(ray_blocks(o, d, tmin, tmax, rb))(
        *box_union(bb6))
    return torch.where(enabled.repeat_interleave(rb)[:R], tmax, -1.0)
