"""The trainer: the MSE loss of a render against a target image, its
gradients with respect to the scene's six parameter leaves, and an Adam
step.

Port of the single-device training path of
raytracer_tpu/parallel/sharding.py: `get_params`, `apply_params`,
`_render_local` (the renderer's per-tile body, shared with
render/renderer.render), `loss_and_grads_scanned` (the production fwd+bwd
step that bench.py measures), `loss_and_grads_streamed` and `train_step`.
The estimator and its random numbers are the JAX package's: pixels are cut
into ray tiles, tile ti renders with fold_in(key, ti), the padding lanes of
the last tile are masked out of the loss, and the summed squared error and
its gradients are scaled by 1 / (R * 3) for R pixels.

The tile loop runs backward once per tile, so autograd holds one tile's
wavefront at a time, and the gradients accumulate into the leaves. The
cluster tables are refreshed from the current vertices once per step, under
no_grad: they shape only the forward hit search; every tracer returns ids
and detached floats, and intersect.refine_hit's straight-through pin is the
only path from a hit to the vertices. Multiple devices (the `mesh`
argument) are ROADMAP queue 1 #14.
"""
from __future__ import annotations

import dataclasses

import torch

from ..convert import PARAM_KEYS
from ..core import rng
from ..core.types import Camera, RenderSettings, Scene
from ..geometry.clusters import refresh_clusters, refresh_iclusters
from ..render import camera as cam_mod
from ..render.renderer import render_pixels as _render_local

__all__ = ['PARAM_KEYS', 'apply_params', 'get_params',
           'loss_and_grads_scanned', 'loss_and_grads_streamed',
           'make_optimizer', 'train_step']


def get_params(scene: Scene) -> dict[str, torch.Tensor]:
    """Copies of the differentiable leaves: vertex positions, material
    albedo and shininess, texels, and the point and rect light powers."""
    leaves = dict(vertices=scene.geom.vertices, kd=scene.materials.kd,
                  spec_exp=scene.materials.spec_exp,
                  tex_data=scene.textures.data,
                  point_power=scene.point_lights.power,
                  rect_power=scene.rect_lights.power)
    return {k: leaves[k].detach().clone() for k in PARAM_KEYS}


def apply_params(scene: Scene, params: dict, refresh: bool = True) -> Scene:
    """The scene with its leaves replaced by `params`. The t = 1 pose moves
    with the vertices (vertices_t1 + shift), so vertex gradients also flow
    through it; refresh=True re-derives the cluster tables (and the
    motion-blurred partition's) from the new vertices."""
    g = scene.geom
    shift = params['vertices'] - g.vertices
    geom = dataclasses.replace(g, vertices=params['vertices'],
                               vertices_t1=g.vertices_t1 + shift)
    clusters, iclusters = scene.clusters, scene.iclusters
    mb_clusters = scene.mb_clusters
    if refresh and clusters is not None:
        clusters = refresh_clusters(clusters, geom, scene.has_motion_blur)
    if refresh and iclusters is not None:
        iclusters = refresh_iclusters(iclusters, geom, scene.instances)
    if refresh and mb_clusters is not None:
        mb_clusters = refresh_clusters(mb_clusters, geom, True)
    rep = dataclasses.replace
    return rep(
        scene, geom=geom, clusters=clusters, iclusters=iclusters,
        mb_clusters=mb_clusters,
        materials=rep(scene.materials, kd=params['kd'],
                      spec_exp=params['spec_exp']),
        textures=rep(scene.textures, data=params['tex_data']),
        point_lights=rep(scene.point_lights, power=params['point_power']),
        rect_lights=rep(scene.rect_lights, power=params['rect_power']))


def loss_and_grads_scanned(params: dict, scene: Scene, cam: Camera,
                           settings: RenderSettings, target: torch.Tensor,
                           key: rng.Key, spp: int = 1,
                           tile: int | None = None, mesh=None):
    """MSE loss and its gradients -> (loss, {leaf: grad}), on the scene's
    device; tile defaults to settings.ray_tile. The JAX package's scanned
    step: one refresh per step, then per tile the masked sum of squared
    errors and its backward pass, accumulated; both scaled by 1 / (R * 3)."""
    if mesh is not None:
        raise NotImplementedError('multiple devices: ROADMAP queue 1 #14')
    W, H = settings.width, settings.height
    R = W * H
    tile = tile or settings.ray_tile
    dev = scene.geom.vertices.device
    px, py = cam_mod.pixel_coords(W, H, dev)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
    tgt = tgt.reshape(-1, 3)
    # zero on the padding lanes: they re-render pixel (0, 0) against a
    # black target
    msk = torch.ones(R, dtype=torch.float32, device=dev)
    pad = (-R) % tile
    if pad:
        px, py, msk = (torch.cat([x, x.new_zeros(pad)]) for x in (px, py, msk))
        tgt = torch.cat([tgt, tgt.new_zeros((pad, 3))])
    with torch.no_grad():
        scene_base = apply_params(scene, {k: params[k].detach()
                                          for k in PARAM_KEYS})
    leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for ti in range(px.shape[0] // tile):
        sl = slice(ti * tile, (ti + 1) * tile)
        s = apply_params(scene_base, leaves, refresh=False)
        L = _render_local(s, cam, settings, spp, px[sl], py[sl],
                          rng.fold_in(key, ti))
        loss = torch.sum(msk[sl, None] * (L - tgt[sl]) ** 2)
        loss.backward()
        total = total + loss.detach()
    scale = 1.0 / (R * 3)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             * scale for k, v in leaves.items()}
    return total * scale, grads


# The JAX package's host-loop variant of the same estimator; here the
# scanned step is a host loop already.
loss_and_grads_streamed = loss_and_grads_scanned


def make_optimizer(params: dict, lr: float = 1e-3,
                   **kw) -> torch.optim.Adam:
    """torch.optim.Adam over the six leaves (optax.adam's defaults:
    betas (0.9, 0.999), eps 1e-8)."""
    return torch.optim.Adam([params[k] for k in PARAM_KEYS], lr=lr, **kw)


def train_step(params: dict, optimizer: torch.optim.Optimizer, scene: Scene,
               cam: Camera, settings: RenderSettings, target, key: rng.Key,
               spp: int = 1, tile: int | None = None, mesh=None):
    """One optimizer step of inverse rendering -> (params, loss): the
    scanned loss and gradients, then `optimizer` (make_optimizer over these
    params) updates the leaves in place."""
    loss, grads = loss_and_grads_scanned(params, scene, cam, settings,
                                         target, key, spp=spp, tile=tile,
                                         mesh=mesh)
    for k in PARAM_KEYS:
        params[k].grad = grads[k]
    optimizer.step()
    return params, loss
