"""Silhouette edge sampling: the boundary term of the vertex gradient.

Port of raytracer_tpu/diff/edges.py. The interior gradient
(ops/intersect.refine_hit) differentiates shading at a fixed hit topology
and cannot see a silhouette move across pixels. These estimators sample
points on silhouette edges and add Li et al. 2018's boundary term

    dI/dtheta += INT_edge (f_in - f_out) (v . n) dl

for primary visibility (single-level and instanced scenes), hard shadows
of point lights and one-bounce GI edges (single-level scenes), as the JAX
package scopes them. The keys, splits and draws are the JAX package's, so
a key samples the same edge points on both. Each estimator is a set of
samples (`EdgeSamples`: each sample's term, velocity and side radiances,
from `primary_edge_samples`, `shadow_edge_samples`, `gi_edge_samples`)
summed onto the vertices.

Differences of representation, not of estimate:
* The screen Jacobian is analytic (`_project_jacobian`, and its chain
  through the light-plane projection in `shadow_edge_vertex_grad`), where
  the JAX package takes jax.jacfwd of the projection.
* Gradients accumulate with index_add_ (the JAX package's .at[].add); on
  the card its atomic adds sum in no fixed order.
* The edge CDF is the running sum of the float32 edge weights taken in
  float64, divided by the total and rounded to float32, so the CPU and the
  card sample the same edges (a float32 torch.cumsum differs between the
  two in the last bits). jnp.cumsum's float32 running sum differs from it
  in the last bits too. The sampling rule is the JAX package's (the first
  edge whose CDF value is >= u, searchsorted's left side), so only a
  sample within that difference of a CDF step can pick the neighbouring
  edge.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..convert import PARAM_KEYS
from ..core import rng
from ..core import vecmath as vm
from ..core.types import (Camera, EdgeTable, MAT_LAMBERT, RenderSettings,
                          Scene)
from ..core.vecmath import EPSILON, MIRO_TMAX, PI
from ..render import camera as cam_mod
from ..render import integrator
from ..shading import textures as tex

# the instanced (instance, edge) pair table's cap: beyond it a scene
# carries no edge table (raytracer_tpu/geometry/build.py:427-436)
PAIR_CAP = 2_000_000


def build_edge_table(face_v) -> EdgeTable:
    """Unique edges keyed by their sorted vertex-id pair, with up to two
    adjacent faces (the second -1 for an open edge, always a silhouette)
    -> EdgeTable on the CPU. Host numpy, as the JAX build makes it."""
    face_v = np.asarray(face_v)
    T = face_v.shape[0]
    e = np.concatenate([face_v[:, [0, 1]], face_v[:, [1, 2]],
                        face_v[:, [2, 0]]])               # (3T, 2)
    f = np.tile(np.arange(T, dtype=np.int64), 3)
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    key = key[order]
    f = f[order]
    uniq = np.ones(len(key), bool)
    uniq[1:] = np.any(key[1:] != key[:-1], axis=1)
    starts = np.flatnonzero(uniq)
    counts = np.diff(np.append(starts, len(key)))
    vid = key[starts].astype(np.int32)
    fid = np.full((len(starts), 2), -1, np.int32)
    fid[:, 0] = f[starts]
    two = counts >= 2
    fid[two, 1] = f[starts[two] + 1]
    return EdgeTable(vid=torch.from_numpy(vid), fid=torch.from_numpy(fid))


def _frame(cam: Camera, width: int, height: int):
    """(u, v, w, top, right) of the pinhole image plane
    (render/camera.eye_rays)."""
    u_dir, v_dir, w_dir = cam_mod.camera_basis(cam)
    f32 = torch.float32
    aspect = torch.tensor(width, dtype=f32) / torch.tensor(height, dtype=f32)
    top = torch.tan(cam.fov * (PI / 360.0))
    right = aspect.to(top.device) * top
    return u_dir, v_dir, w_dir, top, right


def _project(cam: Camera, width: int, height: int, X):
    """World points (..., 3) -> continuous pixel coords (..., 2) and depth
    (..., positive in front); y = 0 is the bottom scanline."""
    u_dir, v_dir, w_dir, top, right = _frame(cam, width, height)
    q = X - cam.eye
    depth = -vm.dot(q, w_dir)
    dc = torch.clamp(depth, min=1e-8)
    im_u = vm.dot(q, u_dir) / dc
    im_v = vm.dot(q, v_dir) / dc
    sx = (im_u / right + 1.0) * 0.5 * width
    sy = (im_v / top + 1.0) * 0.5 * height
    return torch.stack([sx, sy], dim=-1), depth


def _project_jacobian(cam: Camera, width: int, height: int, X):
    """d(sx, sy)/dX of `_project` -> (..., 2, 3), analytic: im = q.u /
    max(depth, 1e-8), and the clamped depth's derivative is -w in front of
    the eye, 0 behind it."""
    u_dir, v_dir, w_dir, top, right = _frame(cam, width, height)
    q = X - cam.eye
    depth = -vm.dot(q, w_dir)
    dc = torch.clamp(depth, min=1e-8)[..., None]
    d_depth = torch.where((depth > 1e-8)[..., None], -w_dir, 0.0)
    d_u = (u_dir - (vm.dot(q, u_dir)[..., None] / dc) * d_depth) / dc
    d_v = (v_dir - (vm.dot(q, v_dir)[..., None] / dc) * d_depth) / dc
    return torch.stack([d_u * (0.5 * width / right),
                        d_v * (0.5 * height / top)], dim=-2)


def _screen_ray(cam: Camera, width: int, height: int, s):
    """Continuous pixel coords (..., 2) -> pinhole camera rays (o, d)."""
    u_dir, v_dir, w_dir, top, right = _frame(cam, width, height)
    im_u = (s[..., 0] / width * 2.0 - 1.0) * right
    im_v = (s[..., 1] / height * 2.0 - 1.0) * top
    d = vm.normalize(im_u[..., None] * u_dir + im_v[..., None] * v_dir
                     - w_dir)
    return cam.eye.expand_as(d), d


def _silhouette(face_n, fid, view):
    """Open edges, and edges whose two faces turn opposite ways to `view`."""
    s0 = vm.dot(face_n[fid[:, 0].clamp(min=0)], view)
    s1 = vm.dot(face_n[fid[:, 1].clamp(min=0)], view)
    return (fid[:, 1] < 0) | (s0 * s1 <= 0.0)


def _sample_edges(w_edge, k_e: rng.Key, k_s: rng.Key, n: int):
    """n edge samples by weight, with a uniform position on each ->
    (edge ids, positions, total weight): the first edge whose CDF value
    is >= u, the CDF summed in float64."""
    dev = w_edge.device
    run = torch.cumsum(w_edge.double(), 0)
    total = run[-1]
    cdf = (run / torch.clamp(total, min=1e-20)).float()
    ue = rng.uniform(k_e, (n,), dev)
    es = torch.searchsorted(cdf, ue).clamp(0, w_edge.shape[0] - 1)
    return es, rng.uniform(k_s, (n,), dev), total.float()


def _face_normals(verts, face_v):
    p = verts[face_v.long()]
    return vm.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])


def _pixel_of(xs, width: int, height: int):
    """The pixel (row, column) that contains each screen point."""
    pxi = torch.floor(xs[:, 0]).to(torch.int64).clamp(0, width - 1)
    pyi = torch.floor(xs[:, 1]).to(torch.int64).clamp(0, height - 1)
    return pyi, pxi


def _need_edges(scene: Scene, what: str) -> EdgeTable:
    if scene.edges is None:
        raise ValueError(
            f'{what} needs scene.edges, which SceneBuilder builds for '
            f'single-level scenes and for instanced scenes of at most '
            f'{PAIR_CAP:,} (instance, edge) pairs; use the interior-only '
            f'gradient (sharding.loss_and_grads_scanned) beyond the cap')
    return scene.edges


@dataclass
class EdgeSamples:
    """The samples of a boundary-term estimator: sample i adds scal[i] (1 -
    ss[i]) vel[i] to vertex vid[es[i], 0] and scal[i] ss[i] vel[i] to
    vertex vid[es[i], 1]. f_plus and f_minus are its side radiances."""
    vid: torch.Tensor       # (E, 2) the sampled edges' endpoints
    es: torch.Tensor        # (M,) edge ids
    ss: torch.Tensor        # (M,) positions along the edges
    scal: torch.Tensor      # (M,)
    vel: torch.Tensor       # (M, 3)
    f_plus: torch.Tensor    # (M, 3)
    f_minus: torch.Tensor   # (M, 3)

    def grad(self, verts) -> torch.Tensor:
        """The samples summed onto the vertices -> verts' shape."""
        grad = torch.zeros_like(verts)
        scal = self.scal[:, None]
        grad.index_add_(0, self.vid[self.es, 0],
                        scal * (1.0 - self.ss)[:, None] * self.vel)
        grad.index_add_(0, self.vid[self.es, 1],
                        scal * self.ss[:, None] * self.vel)
        return grad

    @staticmethod
    def cat(parts: list) -> 'EdgeSamples':
        """Sample sets over the same edges as one."""
        return EdgeSamples(parts[0].vid, *(
            torch.cat([getattr(p, f.name) for p in parts])
            for f in fields(EdgeSamples)[1:]))


def _primary_edges(scene: Scene, cam: Camera, width: int, height: int):
    """The sampling domain of primary visibility -> (vid (E, 2), world
    endpoints a, b (E, 3), weights (E,), the pairs' instance transforms
    (E, 3, 4) or None): every edge of a single-level scene, every
    (instance, edge) pair of an instanced one, weighted by the projected
    length of visible silhouettes. An instanced pair is classified in its
    instance's object space."""
    et = _need_edges(scene, 'edge sampling')
    verts = scene.geom.vertices.detach()
    face_n = _face_normals(verts, scene.geom.face_v)
    eye = cam.eye
    m_pair = None
    if (not scene.single_level) and et.pair_inst is not None:
        pe = et.pair_edge.long()
        vid, fid = et.vid.long()[pe], et.fid.long()[pe]
        m_pair = scene.instances.m[et.pair_inst.long()]          # (P, 3, 4)
        minv_pair = scene.instances.m_inv[et.pair_inst.long()]
        a_obj, b_obj = verts[vid[:, 0]], verts[vid[:, 1]]
        a = torch.einsum('kij,kj->ki', m_pair[:, :, :3], a_obj) \
            + m_pair[:, :, 3]
        b = torch.einsum('kij,kj->ki', m_pair[:, :, :3], b_obj) \
            + m_pair[:, :, 3]
        # the eye in each pair's object space: sign-safe for any affine
        # instance transform
        eye_obj = torch.einsum('kij,kj->ki', minv_pair[:, :, :3],
                               eye.expand(vid.shape[0], 3)) \
            + minv_pair[:, :, 3]
        view = 0.5 * (a_obj + b_obj) - eye_obj
    else:
        vid, fid = et.vid.long(), et.fid.long()
        a, b = verts[vid[:, 0]], verts[vid[:, 1]]
        view = 0.5 * (a + b) - eye
    silhouette = _silhouette(face_n, fid, view)
    pa, da = _project(cam, width, height, a)
    pb, db = _project(cam, width, height, b)
    in_front = (da > 1e-4) & (db > 1e-4)
    on_screen = ((torch.maximum(pa[:, 0], pb[:, 0]) >= 0)
                 & (torch.minimum(pa[:, 0], pb[:, 0]) <= width)
                 & (torch.maximum(pa[:, 1], pb[:, 1]) >= 0)
                 & (torch.minimum(pa[:, 1], pb[:, 1]) <= height))
    slen = torch.linalg.norm(pb - pa, dim=-1)
    w_edge = torch.where(silhouette & in_front & on_screen, slen, 0.0)
    return vid, a, b, w_edge, m_pair


def edge_sampling_vertex_grad(scene: Scene, cam: Camera,
                              settings: RenderSettings, dL_dimg,
                              key: rng.Key, n_samples: int = 4096):
    """Boundary-term gradient of primary visibility, d(loss)/d(vertices)
    -> (V, 3). dL_dimg: (H, W, 3) adjoint of the loss with respect to the
    image, row 0 the bottom scanline. An instanced scene samples its
    (instance, edge) pairs: silhouettes are classified in each pair's
    object space, and velocities chain through the instance transform to
    the shared prototype vertices."""
    return primary_edge_samples(scene, cam, settings, dL_dimg, key,
                                n_samples).grad(scene.geom.vertices.detach())


@torch.no_grad()
def primary_edge_samples(scene: Scene, cam: Camera,
                         settings: RenderSettings, dL_dimg, key: rng.Key,
                         n_samples: int = 4096) -> EdgeSamples:
    """The samples of edge_sampling_vertex_grad."""
    W, H = settings.width, settings.height
    dev = scene.geom.vertices.device
    tracer = integrator.trace_fn(scene, settings)
    eye = cam.eye
    vid, a, b, w_edge, m_pair = _primary_edges(scene, cam, W, H)

    k_e, k_s, k_r = rng.split(key, 3)
    es, ss, total = _sample_edges(w_edge, k_e, k_s, n_samples)
    va, vb = a[es], b[es]
    X = va + ss[:, None] * (vb - va)                       # world points
    xs = _project(cam, W, H, X)[0]
    J = _project_jacobian(cam, W, H, X)                    # (M, 2, 3)
    e2d = _project(cam, W, H, vb)[0] - _project(cam, W, H, va)[0]
    elen = torch.linalg.norm(e2d, dim=-1, keepdim=True)
    edir = e2d / torch.clamp(elen, min=1e-12)
    n2d = torch.stack([edir[:, 1], -edir[:, 0]], dim=-1)

    # radiance half a pixel to either side of the edge
    t0 = torch.zeros(n_samples, dtype=torch.float32, device=dev)
    k1, k2 = rng.split(k_r)
    f_plus = integrator.radiance(scene, settings,
                                 *_screen_ray(cam, W, H, xs + 0.5 * n2d),
                                 t0, k1)
    f_minus = integrator.radiance(scene, settings,
                                  *_screen_ray(cam, W, H, xs - 0.5 * n2d),
                                  t0, k2)

    # an occluded silhouette makes no image discontinuity
    dX = X - eye
    dist = torch.linalg.norm(dX, dim=-1)
    hit = tracer(eye.expand_as(X), dX / torch.clamp(dist, min=1e-12)[:, None],
                 t0, EPSILON, MIRO_TMAX, False)
    visible = hit.t >= dist * (1.0 - 1e-3)

    # box filter: a sample counts in the pixel that contains it. Moving +n
    # replaces f_plus with f_minus; weight total / M (edges by screen
    # length, uniform position)
    adj = dL_dimg[_pixel_of(xs, W, H)]
    scal = vm.dot(adj, f_minus - f_plus)
    scal = torch.where(visible, scal, 0.0) * (total / n_samples)
    Jtn = torch.einsum('mij,mi->mj', J, n2d)               # d/dX_world
    if m_pair is not None:
        # X_world = m_lin X_obj + t: instances sharing a prototype add
        # into the same object-space vertices
        Jtn = torch.einsum('mj,mjk->mk', Jtn, m_pair[es][:, :, :3])
    return EdgeSamples(vid, es, ss, scal, Jtn, f_plus, f_minus)


def _light_plane_jacobian(cam, width, height, q, X, Nr, c):
    """Edge points X seen from the light q, projected onto the receiver
    planes (Nr, c) and then onto the screen -> (screen (M, 2), d
    screen/dX (M, 2, 3)), analytic: Pr = q + t1 (X - q) with t1 = (c -
    q.Nr) / ((X - q).Nr), so dPr/dX = t1 (I - (X - q) Nr^T / ((X - q).Nr))."""
    dir1 = X - q
    den = vm.dot(dir1, Nr)
    t1 = (c - vm.dot(q.expand_as(Nr), Nr)) / den
    Pr = q + t1[:, None] * dir1
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    dPr = t1[:, None, None] * (eye3 - dir1[:, :, None] * Nr[:, None, :]
                               / den[:, None, None])
    J = _project_jacobian(cam, width, height, Pr) @ dPr
    return _project(cam, width, height, Pr)[0], J


def shadow_edge_vertex_grad(scene: Scene, cam: Camera,
                            settings: RenderSettings, dL_dimg,
                            key: rng.Key, n_samples: int = 4096):
    """Boundary-term gradient of hard shadows -> (V, 3). A blocker
    silhouette seen from a point light casts a shadow boundary onto the
    receiver (the first hit beyond the edge point along the light ray);
    the velocity chains through the light-plane projection to the
    blocker's vertices. Point lights, single-level scenes."""
    verts = scene.geom.vertices.detach()
    parts = shadow_edge_samples(scene, cam, settings, dL_dimg, key,
                                n_samples)
    grad = torch.zeros_like(verts)
    for part in parts:
        grad = grad + part.grad(verts)
    return grad


@torch.no_grad()
def shadow_edge_samples(scene: Scene, cam: Camera, settings: RenderSettings,
                        dL_dimg, key: rng.Key,
                        n_samples: int = 4096) -> list:
    """The samples of shadow_edge_vertex_grad, one EdgeSamples for each
    point light that casts shadows."""
    et = _need_edges(scene, 'shadow edge sampling')
    W, H = settings.width, settings.height
    verts = scene.geom.vertices.detach()
    dev = verts.device
    vid, fid = et.vid.long(), et.fid.long()
    tracer = integrator.trace_fn(scene, settings)
    fv = scene.geom.face_v.long()
    face_n = _face_normals(verts, fv)
    eye = cam.eye

    parts = []
    n_lights = scene.point_lights.position.shape[0]
    M = n_samples // max(n_lights, 1)
    t0 = torch.zeros(M, dtype=torch.float32, device=dev)
    for li in range(n_lights):
        if not scene.point_lights.cast_shadows[li]:
            continue
        q = scene.point_lights.position[li]
        # silhouettes seen from the light, sampled by world length (the
        # per-sample |d screen/ds| below corrects to the screen measure)
        a, b = verts[vid[:, 0]], verts[vid[:, 1]]
        silhouette = _silhouette(face_n, fid, 0.5 * (a + b) - q)
        w_edge = torch.where(silhouette, torch.linalg.norm(b - a, dim=-1),
                             0.0)
        k_e, k_s, k_r = rng.split(rng.fold_in(key, li), 3)
        es, ss, total = _sample_edges(w_edge, k_e, k_s, M)
        va, vb = verts[vid[es, 0]], verts[vid[es, 1]]
        X = va + ss[:, None] * (vb - va)
        dirX = X - q
        distX = torch.linalg.norm(dirX, dim=-1)
        dhat = dirX / torch.clamp(distX, min=1e-12)[:, None]

        # the light sees X (another occluder kills the boundary)
        hq = tracer(q.expand_as(X), dhat, t0, EPSILON, MIRO_TMAX, False)
        lit = hq.t >= distX * (1.0 - 1e-3)
        # the receiver: the first hit beyond X along the light ray
        hr = tracer(X, dhat, t0, distX * 1e-3 + 1e-4, MIRO_TMAX, False)
        Pr0 = X + hr.t[:, None] * dhat
        pr = verts[fv[hr.tri.clamp(min=0).long()]]
        Nr = vm.normalize(vm.cross(pr[:, 1] - pr[:, 0], pr[:, 2] - pr[:, 0]))
        xs, JX = _light_plane_jacobian(cam, W, H, q, X, Nr, vm.dot(Pr0, Nr))
        # the shadow curve's tangent: d screen/ds = JX (vb - va)
        e2d = torch.einsum('mij,mj->mi', JX, vb - va)
        elen = torch.linalg.norm(e2d, dim=-1)
        edir = e2d / torch.clamp(elen, min=1e-12)[:, None]
        n2d = torch.stack([edir[:, 1], -edir[:, 0]], dim=-1)

        k1, k2 = rng.split(k_r)
        f_plus = integrator.radiance(
            scene, settings, *_screen_ray(cam, W, H, xs + 0.5 * n2d), t0, k1)
        f_minus = integrator.radiance(
            scene, settings, *_screen_ray(cam, W, H, xs - 0.5 * n2d), t0, k2)

        # the camera sees the receiver point
        dC = Pr0 - eye
        distC = torch.linalg.norm(dC, dim=-1)
        hc = tracer(eye.expand_as(Pr0),
                    dC / torch.clamp(distC, min=1e-12)[:, None], t0,
                    EPSILON, MIRO_TMAX, False)
        vis_cam = hc.t >= distC * (1.0 - 1e-3)
        on_screen = ((xs[:, 0] >= 0) & (xs[:, 0] <= W)
                     & (xs[:, 1] >= 0) & (xs[:, 1] <= H))
        adj = dL_dimg[_pixel_of(xs, W, H)]

        ok = lit & hr.valid & vis_cam & on_screen
        # dl = |d screen/ds| ds and pdf = w_e / total, so the weight is
        # elen total / (w_e M)
        w = torch.where(ok, elen * total
                        / torch.clamp(w_edge[es] * M, min=1e-20), 0.0)
        scal = vm.dot(adj, f_minus - f_plus) * w
        Jtn = torch.einsum('mij,mi->mj', JX, n2d)
        parts.append(EdgeSamples(vid, es, ss, scal, Jtn, f_plus, f_minus))
    return parts


def gi_edge_vertex_grad(scene: Scene, cam: Camera, settings: RenderSettings,
                        dL_dimg, key: rng.Key, n_samples: int = 8192):
    """Boundary-term gradient of one-bounce GI edges -> (V, 3): blocker
    silhouettes seen from the first diffuse vertex P of a pixel-centre
    primary ray, estimated over (pixel, edge point) pairs. The side
    radiances restart the path at P as GI rays of P's material
    (integrator.radiance with kind0=KIND_GI), so they are what the
    integrator's own GI bounce delivers. Single-level scenes, Blinn
    receivers; use at least 8k samples (one pair per sample, rejected on
    the receiver's silhouette test)."""
    return gi_edge_samples(scene, cam, settings, dL_dimg, key,
                           n_samples).grad(scene.geom.vertices.detach())


@torch.no_grad()
def gi_edge_samples(scene: Scene, cam: Camera, settings: RenderSettings,
                    dL_dimg, key: rng.Key,
                    n_samples: int = 8192) -> EdgeSamples:
    """The samples of gi_edge_vertex_grad."""
    et = _need_edges(scene, 'GI edge sampling')
    W, H = settings.width, settings.height
    R = W * H
    g = scene.geom
    verts = g.vertices.detach()
    dev = verts.device
    vid, fid = et.vid.long(), et.fid.long()
    M = n_samples
    tracer = integrator.trace_fn(scene, settings)
    mats = scene.materials
    face_n = _face_normals(verts, g.face_v)

    k_pix, k_e, k_s, k_p, k_m = rng.split(key, 5)

    # receivers: first hits of pixel-centre primary rays
    pix = rng.randint(k_pix, (M,), 0, R, dev).long()
    o0, d0, t0 = cam_mod.eye_rays(
        cam, W, H, (pix % W).float(), (pix // W).float(), 0.5, 0.5, 0.5,
        0.5, torch.full((M, 5), 0.5, device=dev))
    h0 = tracer(o0, d0, t0, EPSILON, MIRO_TMAX, False)
    P = o0 + h0.t[:, None] * d0
    tri = h0.tri.clamp(min=0).long()
    mat = g.face_mat[tri].long()
    N, _, _, _, u, v = integrator.hit_attributes(scene, tri, h0.inst, h0.a,
                                                 h0.b)
    n_hat = vm.normalize(N)
    n_hat = torch.where((vm.dot(n_hat, d0) > 0.0)[:, None], -n_hat, n_hat)
    tc = mats.tex_color[mat]
    diffuse = torch.where((tc >= 0)[:, None],
                          tex.tex_lookup3(scene.textures, tc, u, v),
                          mats.kd[mat])
    emitter = (mats.emitted_power[mat] > 0.0) | (mats.le[mat].sum(-1) > 0.0)
    ok_rec = h0.valid & (mats.kind[mat] != MAT_LAMBERT) & ~emitter \
        & (settings.max_bounces >= 2)

    # edge points uniform by world length; the silhouette test is per
    # receiver, by rejection
    a, b = verts[vid[:, 0]], verts[vid[:, 1]]
    es, ss, total = _sample_edges(torch.linalg.norm(b - a, dim=-1), k_e,
                                  k_s, M)
    va, vb = verts[vid[es, 0]], verts[vid[es, 1]]
    X = va + ss[:, None] * (vb - va)
    dirX = X - P
    r = torch.linalg.norm(dirX, dim=-1)
    w = dirX / torch.clamp(r, min=1e-12)[:, None]
    cos_t = vm.dot(w, n_hat)
    silhouette = _silhouette(face_n, fid[es], dirX)
    # the edge is the foremost geometry from P along w
    hx = tracer(P, w, t0, EPSILON, MIRO_TMAX, False)
    foremost = hx.t >= r * (1.0 - 1e-3)

    # the curve on the direction sphere: tangent dw/ds, normal n_c in the
    # tangent plane at w
    eab = vb - va
    tau = (eab - w * vm.dot(w, eab)[:, None]) \
        / torch.clamp(r, min=1e-12)[:, None]
    tau_len = torch.linalg.norm(tau, dim=-1)
    n_c = vm.cross(w, tau / torch.clamp(tau_len, min=1e-12)[:, None])

    delta = 3e-3
    f_plus = integrator.radiance(
        scene, settings, P, vm.normalize(w + delta * n_c), t0,
        rng.fold_in(k_p, 1), kind0=integrator.KIND_GI, prev_mat0=mat,
        gi_bounces0=1)
    f_minus = integrator.radiance(
        scene, settings, P, vm.normalize(w - delta * n_c), t0,
        rng.fold_in(k_m, 2), kind0=integrator.KIND_GI, prev_mat0=mat,
        gi_bounces0=1)

    adj = dL_dimg[pix // W, pix % W]
    ok = ok_rec & silhouette & foremost & (cos_t > 1e-3) & (r > 1e-4) \
        & (tau_len > 1e-9)
    # pdf(pixel) = 1/R, pdf(edge point) = 1/total per unit length, and
    # dl_w = |dw/ds| ds
    wgt = torch.where(ok, R * tau_len * total / M, 0.0)
    q = diffuse * (cos_t / PI)[:, None]
    scal = vm.dot(adj * q, f_minus - f_plus) * wgt
    # dw/dva . n_c = (1 - s) n_c / r (n_c is tangent already)
    return EdgeSamples(vid, es, ss, scal / torch.clamp(r, min=1e-12), n_c,
                       f_plus, f_minus)


def edge_adjoint(params: dict, scene: Scene, cam: Camera,
                 settings: RenderSettings, target, key: rng.Key,
                 spp: int = 1):
    """What the boundary terms of the MSE loss at `params` start from ->
    (the scene at params, dL/dimg = 2 (img - target) / (H W 3) from a
    fresh forward render keyed from fold_in(key, 0x0ede), and the keys of
    the primary, shadow and GI terms)."""
    from ..parallel import sharding
    from ..render import renderer

    W, H = settings.width, settings.height
    with torch.no_grad():
        s = sharding.apply_params(scene, {k: params[k].detach()
                                          for k in PARAM_KEYS})
        k_img, k_edge, k_sh = rng.split(rng.fold_in(key, 0x0ede), 3)
        img = renderer.render(s, cam, settings, k_img, spp=spp)
        tgt = torch.as_tensor(target, dtype=torch.float32, device=img.device)
        dL_dimg = 2.0 * (img - tgt) / (W * H * 3)
    return s, dL_dimg, dict(primary=k_edge, shadow=k_sh,
                            gi=rng.fold_in(key, 0x61ed))


def boundary_grads(params: dict, scene: Scene, cam: Camera,
                   settings: RenderSettings, target, key: rng.Key,
                   spp: int = 1, edge_samples: int = 4096,
                   shadow_edges: bool = True,
                   gi_edges: bool = False) -> dict:
    """The boundary terms of the vertex gradient of the MSE loss at
    `params` -> {'primary': g, 'shadow': g, 'gi': g} (the terms that
    apply, each (V, 3)): shadows for single-level scenes with
    shadow-casting point lights, GI for single-level path-traced ones
    (with at least 8192 samples)."""
    _need_edges(scene, 'loss_and_grads_with_edges')
    s, dL_dimg, keys = edge_adjoint(params, scene, cam, settings, target,
                                    key, spp)
    out = dict(primary=edge_sampling_vertex_grad(
        s, cam, settings, dL_dimg, keys['primary'], n_samples=edge_samples))
    if shadow_edges and scene.single_level \
            and any(scene.point_lights.cast_shadows):
        out['shadow'] = shadow_edge_vertex_grad(
            s, cam, settings, dL_dimg, keys['shadow'],
            n_samples=edge_samples)
    if gi_edges and scene.single_level and settings.path_trace:
        out['gi'] = gi_edge_vertex_grad(
            s, cam, settings, dL_dimg, keys['gi'],
            n_samples=max(edge_samples, 8192))
    return out


def loss_and_grads_with_edges(params: dict, scene: Scene, cam: Camera,
                              settings: RenderSettings, target,
                              key: rng.Key, spp: int = 1,
                              tile: int | None = None,
                              edge_samples: int = 4096,
                              shadow_edges: bool = True,
                              gi_edges: bool = False, mesh=None):
    """Interior (autograd) plus boundary (edge-sampled) gradients of the
    MSE loss -> (loss, {leaf: grad}): sharding.loss_and_grads_scanned,
    then `boundary_grads` added to the vertices' gradient in the order
    primary, shadow, GI."""
    from ..parallel import sharding

    _need_edges(scene, 'loss_and_grads_with_edges')
    loss, grads = sharding.loss_and_grads_scanned(
        params, scene, cam, settings, target, key, spp=spp, tile=tile,
        mesh=mesh)
    grads = dict(grads)
    for g in boundary_grads(params, scene, cam, settings, target, key,
                            spp=spp, edge_samples=edge_samples,
                            shadow_edges=shadow_edges,
                            gi_edges=gi_edges).values():
        grads['vertices'] = grads['vertices'] + g
    return loss, grads


def train_step_with_edges(params: dict, optimizer: torch.optim.Optimizer,
                          scene: Scene, cam: Camera,
                          settings: RenderSettings, target, key: rng.Key,
                          spp: int = 1, tile: int | None = None,
                          edge_samples: int = 4096, mesh=None):
    """One optimizer step on the interior plus boundary gradient ->
    (params, loss), as sharding.train_step: `optimizer`
    (sharding.make_optimizer over these params) updates the leaves in
    place."""
    loss, grads = loss_and_grads_with_edges(
        params, scene, cam, settings, target, key, spp=spp, tile=tile,
        edge_samples=edge_samples, mesh=mesh)
    for k in PARAM_KEYS:
        params[k].grad = grads[k]
    optimizer.step()
    return params, loss
