"""Ray-triangle intersection, the brute-force tracer and the differentiable
hit refinement.

Port of raytracer_tpu/ops/intersect.py. Tracers return integer ids and
detached floats; `refine_hit` recomputes (t, a, b) of the selected
triangle so that gradients reach the vertices, with the forward values
pinned to the tracer's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from ..shading import textures as tex


@dataclass
class Hit:
    t: torch.Tensor      # (R,) f32, MIRO_TMAX on a miss
    tri: torch.Tensor    # (R,) i32, -1 on a miss
    inst: torch.Tensor   # (R,) i32, 0 for single-level scenes
    a: torch.Tensor      # (R,) f32 barycentric (v1 weight)
    b: torch.Tensor      # (R,) f32 barycentric (v2 weight)

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def mt_intersect(o, d, p0, p1, p2):
    """Batched Moller-Trumbore (src/Object.cpp:109-147) -> (t, a, b, ok);
    ok holds the barycentric tests only, callers apply the t range."""
    e0 = p1 - p0
    e1 = p2 - p0
    pvec = vm.cross(d, e1)
    det = vm.dot(e0, pvec)
    inv_det = 1.0 / det
    tvec = o - p0
    a = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e0)
    b = vm.dot(d, qvec) * inv_det
    t = vm.dot(e1, qvec) * inv_det
    ok = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (a + b <= 1.0) & (det != 0.0)
    return t, a, b, ok


def gather_tri_verts(scene: Scene, tri, time, corners=None):
    """Triangle corners -> (..., 3, 3) [corner, xyz]. A motion-blurred
    scene lerps them by ray time, v0 + time (v1 - v0) (MBObject::intersect,
    src/MBObject.cpp:26-107); static triangles have v1 == v0. The corner
    index (..., 3) goes to take whole, so that the gradient's scatter
    finds each corner's runs of equal vertices. `corners`, where given, is
    v0 (tri_corners(scene, tri)), gathered once for several readers."""
    f = vm.take(scene.geom.face_v, tri)
    v0 = tri_corners(scene, tri) if corners is None else corners
    if scene.has_motion_blur:
        v1 = vm.take(scene.geom.vertices_t1, f, 'corners')
        w = torch.as_tensor(time, dtype=v0.dtype, device=v0.device)
        w = w.expand(tri.shape)[..., None, None]
        return v0 + w * (v1 - v0)
    return v0


def tri_corners(scene: Scene, tri):
    """The corners at time 0 of triangles tri -> (..., 3, 3) [corner,
    xyz], through one take (site `corners`)."""
    return vm.take(scene.geom.vertices, vm.take(scene.geom.face_v, tri),
                   'corners')


def alpha_of(scene: Scene, tri, a, b):
    """The alpha-map cutout value at a hit (src/Object.cpp:150-166); 1
    where the material has no alpha map. The texture coordinate is the
    corners' sum weighted (1 - a - b, a, b), in that order."""
    mat = scene.geom.face_mat[tri].long()
    tex_id = scene.materials.tex_alpha[mat]
    has_uv = scene.geom.face_has_uv[tri]
    uvs = scene.geom.texcoords[scene.geom.face_t[tri].long()]   # (..., 3, 2)
    c = 1.0 - a - b
    uv = (uvs[..., 0, :] * c[..., None] + uvs[..., 1, :] * a[..., None]) \
        + uvs[..., 2, :] * b[..., None]
    u = torch.where(has_uv, uv[..., 0], a)
    v = torch.where(has_uv, uv[..., 1], b)
    alpha = tex.tex_lookup_alpha(scene.textures, tex_id, u, v)
    return torch.where(tex_id >= 0, alpha, torch.ones_like(alpha))


def ray_inputs(o, time, tmin, tmax):
    """Broadcast time, tmin and tmax (scalars or (R,)) to (R,) contiguous
    float32 tensors on o's device, detached."""
    R = o.shape[0]

    def per_ray(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=o.device)
        return x.detach().expand(R).contiguous()
    return per_ray(time), per_ray(tmin), per_ray(tmax)


def brute_force_trace(scene: Scene, o, d, time, tmin, tmax,
                      any_hit: bool = False, chunk: int = 256) -> Hit:
    """Every ray against every triangle, in triangle chunks (the test
    oracle; src/BVH.cpp:1114-1126). Nearest hit, ties to the lowest id;
    motion blur lerps the corners by ray time, and alpha cutouts
    (alpha < 0.5) never hit."""
    R = o.shape[0]
    Tn = scene.num_tris
    o, d = o.detach(), d.detach()
    time, tmin, tmax = ray_inputs(o, time, tmin, tmax)
    best_t = torch.clamp(tmax, max=MIRO_TMAX)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    best_a = torch.zeros(R, device=o.device)
    best_b = torch.zeros(R, device=o.device)
    for c0 in range(0, Tn, chunk):
        tid = torch.arange(c0, min(c0 + chunk, Tn), device=o.device)
        tids = tid[None].expand(R, -1)
        # per-ray corners only when they move; else one set, broadcast
        p = (gather_tri_verts(scene, tids, time[:, None])
             if scene.has_motion_blur
             else gather_tri_verts(scene, tid, 0.0)[None]).detach()
        t, a, b, ok = mt_intersect(o[:, None], d[:, None], p[..., 0, :],
                                   p[..., 1, :], p[..., 2, :])
        ok = ok & (t >= tmin[:, None]) & (t < best_t[:, None]) \
            & (t < tmax[:, None])
        if scene.has_alpha_maps:
            ok = ok & (alpha_of(scene, tids, a, b) >= 0.5)
        t = torch.where(ok, t, torch.inf)
        tk, k = torch.min(t, dim=-1)     # first index among equal minima
        found = torch.isfinite(tk)
        rows = torch.arange(R, device=o.device)
        best_tri = torch.where(found, tid[k].to(torch.int32), best_tri)
        best_a = torch.where(found, a[rows, k], best_a)
        best_b = torch.where(found, b[rows, k], best_b)
        best_t = torch.where(found, tk, best_t)
    t = torch.where(best_tri >= 0, best_t, torch.full_like(best_t, MIRO_TMAX))
    return Hit(t=t, tri=best_tri, inst=torch.zeros_like(best_tri),
               a=best_a, b=best_b)


def refine_hit(scene: Scene, o, d, time, hit: Hit, corners=None):
    """Differentiable (t, a, b) for the selected triangle.

    The forward values are pinned to the tracer's (recomputing t at a
    grazing triangle could move the shading point inside the surface);
    gradients flow through the recomputation. On a two-level scene the ray
    moves into the hit instance's object space through m_inv[inst], a
    constant: transform gradients are not computed (as in the JAX
    package). Lanes without a hit recompute against a fixed triangle
    that a fixed ray meets head-on: against the clamped id 0 a ray in
    that triangle's plane has det == 0, and the 0 * inf of its dropped
    branch would make the vertex gradients NaN (a guard the JAX package
    lacks). `corners`, where given, are the time-0 corners of the
    clamped ids (tri_corners(scene, hit.tri.clamp(min=0))), which the
    bounce step gathers once for this and hit_attributes; the result is
    the same, bit for bit, and so is the gradient."""
    v = hit.valid
    tri = torch.clamp(hit.tri, min=0)
    p = gather_tri_verts(scene, tri, time, corners)
    if not scene.single_level:
        mi = scene.instances.m_inv[hit.inst.clamp(min=0).long()].detach()
        o, d = vm.transform_point(mi, o), vm.transform_vector(mi, d)
    keep = v[..., None]
    o = torch.where(keep, o, o.new_tensor([0.0, 0.0, -1.0]))
    d = torch.where(keep, d, d.new_tensor([0.0, 0.0, 1.0]))
    p = torch.where(keep[..., None], p, p.new_tensor(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    t, a, b, _ = mt_intersect(o, d, p[..., 0, :], p[..., 1, :], p[..., 2, :])
    t = hit.t + (t - t.detach())
    a = hit.a + (a - a.detach())
    b = hit.b + (b - b.detach())
    return (torch.where(v, t, torch.full_like(t, MIRO_TMAX)),
            torch.where(v, a, torch.zeros_like(a)),
            torch.where(v, b, torch.zeros_like(b)))
