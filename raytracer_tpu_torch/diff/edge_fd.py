"""Finite-difference checks of the edge-sampled gradients (diff/edges.py).

The JAX package's fixtures of tests/test_edge_grad.py, built by the port
at 32x32 on `device`, and its four comparisons of an estimator with a
central finite difference of the MSE loss against a target rendered with
the geometry shifted in x. Each finite difference renders at +-eps with
common random numbers (the same key on both sides, pixel-integrated by
`spp` jittered samples, so interior samples cancel and only side flips
remain) and averages over keys 0, 1, (2). Each check returns the
estimator's x-translation derivative `grad`, the finite difference `fd`
(and each key's `fds`), the gradient that must be blind to the boundary
(`blind`), and the tolerance the tests hold them to, with the scenes,
keys, sample counts and calibrations of the JAX tests:

  silhouette  a bright triangle over black, its silhouette (:147);
  shadow      an off-frame blocker's hard shadow on a lit floor (:73);
  instanced   three instances of a one-triangle prototype (:219);
  gi          a floor lit only by one-bounce GI past an off-frame
              blocker (:284).

`shadow_fit` is the inverse-rendering run of :112: Adam on the blocker's
vertices through the shadow term alone.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng
from ..core.types import CUDA, Camera, RenderSettings
from ..geometry import shapes
from ..geometry.build import SceneBuilder
from ..io.objload import make_single_triangle
from ..parallel import sharding
from ..render import renderer
from . import edges

SIZE = 32


def _settings(**kw) -> RenderSettings:
    return RenderSettings(width=SIZE, height=SIZE, ray_tile=SIZE * SIZE,
                          **kw)


def tri_scene(dx: float = 0.0, device=CUDA):
    """One bright Lambert triangle over a black background, shifted dx."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.add_mesh(make_single_triangle((-1.0 + dx, -1.0, 0.0),
                                    (1.0 + dx, -1.0, 0.0),
                                    (0.0 + dx, 1.0, 0.0), n=(0, 0, 1)), lam)
    b.add_point_light((0, 0, 5), 300.0, cast_shadows=False)
    b.set_bg_color((0.0, 0.0, 0.0))
    cam = Camera.make(eye=(0, 0, 4), look_at=(0, 0, 0), fov=60.0)
    return (b.build(bvh=False, device=device), cam.to(device),
            _settings(path_trace=False, max_wavefront_steps=2))


def blocker_scene(dx: float = 0.0, device=CUDA):
    """A blocker triangle 1.5 above a lit floor, out of frame: only its
    hard shadow shows."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(0.9, 0.9, 0.9))
    b.add_mesh(shapes.quad((-4, 0, 4), (4, 0, 4), (4, 0, -4), (-4, 0, -4),
                           with_uv=False), lam)
    blk = b.add_lambert(kd=(0.4, 0.2, 0.2))
    b.add_mesh(make_single_triangle((-0.7 + dx, 1.5, -0.5),
                                    (0.7 + dx, 1.5, -0.5),
                                    (dx, 1.5, 0.7), n=(0, 1, 0)), blk)
    b.add_point_light((0.0, 4.0, 0.0), 250.0, cast_shadows=True,
                      fast_shadows=True)
    b.set_bg_color((0, 0, 0))
    cam = Camera.make(eye=(0.0, 1.2, 3.2), look_at=(0.0, 0.0, 0.0), fov=40.0)
    return (b.build(bvh=False, device=device), cam.to(device),
            _settings(path_trace=False, max_wavefront_steps=2))


def inst_tri_scene(dx: float = 0.0, device=CUDA):
    """Three instances (translated, scaled) of a one-triangle prototype
    over black: moving the prototype moves three silhouettes."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.begin_prototype()
    b.add_mesh(make_single_triangle((-0.6 + dx, -0.6, 0.0),
                                    (0.6 + dx, -0.6, 0.0),
                                    (dx, 0.6, 0.0), n=(0, 0, 1)), lam)
    proto = b.end_prototype()
    for tx, s in ((-1.3, 1.0), (0.0, 0.8), (1.3, 1.2)):
        b.add_instance(proto, np.asarray([[s, 0, 0, tx], [0, s, 0, 0],
                                          [0, 0, 1, 0]], np.float32))
    b.add_point_light((0, 0, 6), 300.0, cast_shadows=False)
    b.set_bg_color((0.0, 0.0, 0.0))
    cam = Camera.make(eye=(0, 0, 5), look_at=(0, 0, 0), fov=55.0)
    return (b.build(bvh=True, device=device), cam.to(device),
            _settings(path_trace=False, max_wavefront_steps=2,
                      intersector='cluster2'))


def gi_blocker_scene(dx: float = 0.0, device=CUDA):
    """A floor lit only by one-bounce GI from an off-frame emissive panel,
    past an off-frame blocker: no light, no camera edge."""
    b = SceneBuilder()
    floor = b.add_blinn(kd=(0.8, 0.8, 0.8))
    b.add_mesh(shapes.quad((-4, 0, 4), (4, 0, 4), (4, 0, -4), (-4, 0, -4),
                           with_uv=False), floor)
    emit = b.add_blinn(kd=(0.0, 0.0, 0.0), le=(4.0, 4.0, 4.0),
                       emitted_power=3.0)
    b.add_mesh(shapes.quad((1.5, 3.0, 1.0), (3.5, 3.0, 1.0),
                           (3.5, 3.0, -1.0), (1.5, 3.0, -1.0),
                           with_uv=False), emit)
    blk = b.add_blinn(kd=(0.2, 0.2, 0.2))
    b.add_mesh(make_single_triangle((0.6 + dx, 1.2, -0.7),
                                    (0.6 + dx, 1.2, 0.7),
                                    (1.4 + dx, 1.2, 0.0), n=(0, 1, 0)), blk)
    b.set_bg_color((0, 0, 0))
    cam = Camera.make(eye=(0.0, 2.2, 0.0), look_at=(0.0, 0.0, 0.01),
                      fov=35.0)
    return (b.build(bvh=False, device=device), cam.to(device),
            _settings(path_trace=True, max_bounces=2,
                      max_wavefront_steps=3))


def finite_difference(make, shift: float, eps: float, keys: int, spp: int,
                      device=CUDA):
    """(target, mean fd, [fd of each key]): the target rendered with the
    geometry at +shift (key 42), then the central difference of the MSE
    loss at dx = +-eps, each key on both sides."""
    _, cam, st = make(0.0, device)

    def img(dx, k):
        return renderer.render(make(dx, device)[0], cam, st,
                               rng.PRNGKey(k), spp=spp)

    with torch.no_grad():
        target = img(shift, 42)

        def loss(dx, k):
            return float(((img(dx, k) - target) ** 2).sum()
                         / (SIZE * SIZE * 3))
        fds = [(loss(eps, k) - loss(-eps, k)) / (2 * eps)
               for k in range(keys)]
    return target, float(np.mean(fds)), fds


def _dx(grads, rows=slice(None)) -> float:
    """The derivative along a uniform +x shift of the vertices `rows`."""
    return float(grads['vertices'][rows, 0].sum())


def silhouette(device=CUDA) -> dict:
    """test_edge_grad.py:147. Calibrated there: fd = -0.1417 +- 0.004,
    the estimator -0.1389 +- 0.002, the interior 0."""
    scene, cam, st = tri_scene(0.0, device)
    target, fd, fds = finite_difference(tri_scene, 0.2, 2e-2, 2, 64, device)
    params = sharding.get_params(scene)
    key = rng.PRNGKey(0)
    _, grads = edges.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, spp=8, edge_samples=16384)
    _, interior = sharding.loss_and_grads_scanned(
        params, scene, cam, st, target, key, spp=8, tile=SIZE * SIZE)
    return dict(grad=_dx(grads), fd=fd, fds=fds, fd_min=0.05,
                blind=_dx(interior), blind_max=0.25 * abs(fd), rtol=0.25)


def shadow(device=CUDA) -> dict:
    """test_edge_grad.py:73. Calibrated there: fd = -0.358 +- 0.02, the
    shadow estimator -0.31, the primary term alone 0. The blocker's
    vertices are rows 4-6."""
    scene, cam, st = blocker_scene(0.0, device)
    target, fd, fds = finite_difference(blocker_scene, 0.25, 2e-2, 2, 64,
                                        device)
    params = sharding.get_params(scene)
    key = rng.PRNGKey(0)
    _, g_off = edges.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, spp=8, edge_samples=8192,
        shadow_edges=False)
    _, g_on = edges.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, spp=8, edge_samples=16384,
        shadow_edges=True)
    return dict(grad=_dx(g_on, slice(4, None)), fd=fd, fds=fds, fd_min=0.1,
                blind=_dx(g_off, slice(4, None)), blind_max=0.15 * abs(fd),
                rtol=0.3)


def instanced(device=CUDA) -> dict:
    """test_edge_grad.py:219: the prototype's x-shift through the three
    instances' silhouettes; held to |grad - fd| < 0.35 |fd| + 1e-4."""
    scene, cam, st = inst_tri_scene(0.0, device)
    target, fd, fds = finite_difference(inst_tri_scene, 0.25, 2.5e-2, 2, 16,
                                        device)
    _, grads = edges.loss_and_grads_with_edges(
        sharding.get_params(scene), scene, cam, st, target, rng.PRNGKey(1),
        spp=16, edge_samples=4096)
    return dict(grad=_dx(grads), fd=fd, fds=fds, fd_min=0.0, blind=None,
                blind_max=None, rtol=0.35, atol=1e-4,
                pairs=int(scene.edges.pair_inst.shape[0]))


def gi(device=CUDA) -> dict:
    """test_edge_grad.py:284. Calibrated there: fd = -0.18 +- 0.03 (3
    keys), the estimator -0.21 at 8k samples; without GI edges the
    blocker's gradient is exactly 0. The blocker is the last 3 rows."""
    scene, cam, st = gi_blocker_scene(0.0, device)
    target, fd, fds = finite_difference(gi_blocker_scene, 0.2, 5e-2, 3, 64,
                                        device)
    params = sharding.get_params(scene)
    key = rng.PRNGKey(0)
    _, g_off = edges.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, spp=8, edge_samples=8192,
        shadow_edges=False, gi_edges=False)
    _, g_on = edges.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, spp=8, edge_samples=8192,
        shadow_edges=False, gi_edges=True)
    return dict(grad=_dx(g_on, slice(-3, None)), fd=fd, fds=fds, fd_min=0.05,
                blind=_dx(g_off, slice(-3, None)), blind_max=1e-6,
                rtol=0.35)


CHECKS = dict(silhouette=silhouette, shadow=shadow, instanced=instanced,
              gi=gi)


def holds(r: dict) -> bool:
    """The JAX tests' rule: a finite fd above fd_min in size (nonzero
    where fd_min is 0), the estimator of fd's sign within rtol of it
    (rtol |fd| + atol where the check has an atol), and the blind
    gradient below its bound."""
    fd, g = r['fd'], r['grad']
    ok = np.isfinite(fd) and abs(fd) > r['fd_min'] and fd != 0.0 \
        and np.sign(g) == np.sign(fd)
    if r.get('atol') is not None:
        ok = ok and abs(g - fd) < r['rtol'] * abs(fd) + r['atol']
    else:
        ok = ok and abs(g - fd) <= r['rtol'] * abs(fd)
    if r['blind_max'] is not None:
        ok = ok and abs(r['blind']) < r['blind_max']
    return bool(ok)


def shadow_fit(device=CUDA, steps: int = 12) -> dict:
    """test_edge_grad.py:112: Adam (lr 3e-2) on the vertices alone, the
    floor's four rows held still, toward a target whose blocker sits
    +0.25 in x, through loss_and_grads_with_edges (spp 4, 4,096 edge
    samples, key fold_in(1, i)) -> the losses and the blocker's mean x
    shift."""
    scene, cam, st = blocker_scene(0.0, device)
    with torch.no_grad():
        target = renderer.render(blocker_scene(0.25, device)[0], cam, st,
                                 rng.PRNGKey(42), spp=32)
    params = sharding.get_params(scene)
    opt = torch.optim.Adam([params['vertices']], lr=3e-2)
    key = rng.PRNGKey(1)
    losses = []
    for i in range(steps):
        loss, grads = edges.loss_and_grads_with_edges(
            params, scene, cam, st, target, rng.fold_in(key, i), spp=4,
            edge_samples=4096)
        g = grads['vertices'].clone()
        g[:4] = 0.0
        params['vertices'].grad = g
        opt.step()
        losses.append(float(loss))
    moved = float(params['vertices'][4:, 0].mean()
                  - scene.geom.vertices[4:, 0].mean())
    return dict(losses=losses, moved=moved)
