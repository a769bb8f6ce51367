"""The trainer: the MSE loss of a render against a target image, its
gradients with respect to the scene's six parameter leaves, and an Adam
step.

Port of raytracer_tpu/parallel/sharding.py: `get_params`, `apply_params`,
`_render_local` (the renderer's per-tile body, shared with
render/renderer.render), `loss_and_grads_scanned` (the production fwd+bwd
step that bench.py measures), `loss_and_grads_streamed` and `train_step`,
and their several-rank forms over a `mesh` (`make_mesh`, over the ranks of
parallel/distributed.py): `render_sharded`, `loss_and_grads`, the `mesh`
of the scanned step and of `train_step`, and the geometry-sharded
`render_geometry_sharded` and `loss_and_grads_geometry_sharded`, whose
ranks each keep one shard of the cluster table (ops/ring_trace.py).
The estimator and its random numbers are the JAX package's: pixels are cut
into ray tiles, tile ti renders with fold_in(key, ti), the padding lanes of
the last tile are masked out of the loss, and the summed squared error and
its gradients are scaled by 1 / (R * 3) for R pixels.

The tile loop runs backward once per tile, so autograd holds one tile's
wavefront at a time, and the gradients accumulate into the leaves. The
cluster tables are refreshed from the current vertices once per step, under
no_grad: they shape only the forward hit search; every tracer returns ids
and detached floats, and intersect.refine_hit's straight-through pin is the
only path from a hit to the vertices. Under a mesh every rank computes
its share of the sums and one all_reduce combines them, so the result is
the single-process one up to the order of the float32 sums.
"""
from __future__ import annotations

import dataclasses

import torch

from ..convert import PARAM_KEYS
from ..core import rng
from ..core.types import Camera, RenderSettings, Scene
from ..geometry.clusters import refresh_clusters, refresh_iclusters
from ..ops import ring_trace as ring
from ..render import camera as cam_mod
from ..render.renderer import render_pixels as _render_local
from . import distributed

__all__ = ['PARAM_KEYS', 'apply_params', 'get_params', 'loss_and_grads',
           'loss_and_grads_geometry_sharded', 'loss_and_grads_scanned',
           'loss_and_grads_streamed', 'make_mesh', 'make_optimizer',
           'render_geometry_sharded', 'render_sharded', 'train_step']


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


def make_mesh(n: int | None = None) -> distributed.Mesh:
    """The 1-D 'rays' mesh over the first n ranks of the initialised
    process group (distributed.init_from_env); raises without one."""
    return distributed.global_mesh(n)


def _chunk(x, D: int, i: int):
    """Share i of D of x: x padded with zeros to a multiple of D rows, cut
    into D contiguous shares."""
    pad = (-x.shape[0]) % D
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    n = x.shape[0] // D
    return x[i * n:(i + 1) * n]


def _pixels(settings: RenderSettings, target, dev):
    """(px, py, target rows, mask) of every pixel: the mask is 1 on the
    pixels and 0 on the padding lanes that _chunk and the tiles add."""
    px, py = cam_mod.pixel_coords(settings.width, settings.height, dev)
    tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)
    return px, py, tgt.reshape(-1, 3), torch.ones_like(px)


def _shard_render(scene: Scene, cam: Camera, settings: RenderSettings,
                  key: rng.Key, mesh, spp: int) -> torch.Tensor:
    """Rank i renders its pixel chunk with fold_in(key, i); the chunks of
    every rank, gathered -> (H, W, 3)."""
    W, H = settings.width, settings.height
    px, py = cam_mod.pixel_coords(W, H, scene.geom.vertices.device)
    D, i = mesh.size, mesh.rank
    L = _render_local(scene, cam, settings, spp, _chunk(px, D, i),
                      _chunk(py, D, i), rng.fold_in(key, i))
    return distributed.all_gather_rows(L, mesh)[:W * H].reshape(H, W, 3)


def render_sharded(scene: Scene, cam: Camera, settings: RenderSettings,
                   key: rng.Key, mesh, spp: int = 1) -> torch.Tensor:
    """Data-parallel render -> the (H, W, 3) image on every rank of the
    mesh. The pixels are padded to a multiple of the rank count D; rank i
    renders pixels [i R / D, (i + 1) R / D) in one wavefront with
    fold_in(key, i) (raytracer_tpu/parallel/sharding.py:68-89)."""
    with torch.no_grad():
        return _shard_render(scene, cam, settings, key,
                             distributed.check_mesh(mesh), spp)


def render_geometry_sharded(scene: Scene, cam: Camera,
                            settings: RenderSettings, key: rng.Key, mesh,
                            spp: int = 1) -> torch.Tensor:
    """Geometry-sharded render: each rank keeps one shard of the cluster
    table (ops/ring_trace.local_shard) and its rays meet the others' on
    the ring (intersector 'ring'); rays are sharded as in render_sharded,
    with the same keys (raytracer_tpu/parallel/sharding.py:92-125)."""
    mesh = distributed.check_mesh(mesh)
    if scene.clusters is None:
        raise ValueError('geometry sharding needs the cluster table')
    s = dataclasses.replace(scene,
                            clusters=ring.local_shard(scene.clusters, mesh))
    with torch.no_grad():
        return _shard_render(s, cam, dataclasses.replace(
            settings, intersector='ring'), key, mesh, spp)


def _accumulate(params: dict, scene_base: Scene, cam: Camera,
                settings: RenderSettings, spp: int, tiles):
    """Sum over `tiles` of (px, py, target rows, mask, key) of the masked
    sum of squared errors, each tile's backward pass run before the next
    one's forward -> (total, {leaf: summed grad})."""
    dev = scene_base.geom.vertices.device
    leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for pxt, pyt, tgt, msk, k in tiles:
        s = apply_params(scene_base, leaves, refresh=False)
        L = _render_local(s, cam, settings, spp, pxt, pyt, k)
        loss = torch.sum(msk[:, None] * (L - tgt) ** 2)
        loss.backward()
        total = total + loss.detach()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items()}
    return total, grads


def _finish(total, grads, R: int, mesh=None):
    """Sum over the mesh's ranks (one all_reduce), then the MSE's
    1 / (R * 3) -> (loss, {leaf: grad})."""
    if mesh is not None:
        total, *g = distributed.all_reduce_sum(
            [total] + [grads[k] for k in PARAM_KEYS], mesh)
        grads = dict(zip(PARAM_KEYS, g))
    scale = 1.0 / (R * 3)
    return total * scale, {k: grads[k] * scale for k in PARAM_KEYS}


def _base(scene: Scene, params: dict) -> Scene:
    with torch.no_grad():
        return apply_params(scene, {k: params[k].detach()
                                    for k in PARAM_KEYS})


def loss_and_grads(params: dict, scene: Scene, cam: Camera,
                   settings: RenderSettings, target, key: rng.Key, mesh,
                   spp: int = 1):
    """Whole-image MSE and its gradients, rays sharded as in
    render_sharded (raytracer_tpu/parallel/sharding.py:178-193): each rank
    runs backward on the masked sum of squared errors of its chunk, then
    one all_reduce sums the loss and the six leaves' gradients over the
    ranks (no gradient goes through the gather)."""
    mesh = distributed.check_mesh(mesh)
    dev = scene.geom.vertices.device
    px, py, tgt, msk = (_chunk(x, mesh.size, mesh.rank)
                        for x in _pixels(settings, target, dev))
    total, grads = _accumulate(params, _base(scene, params), cam, settings,
                               spp, [(px, py, tgt, msk,
                                      rng.fold_in(key, mesh.rank))])
    return _finish(total, grads, settings.width * settings.height, mesh)


def loss_and_grads_scanned(params: dict, scene: Scene, cam: Camera,
                           settings: RenderSettings, target: torch.Tensor,
                           key: rng.Key, spp: int = 1,
                           tile: int | None = None, mesh=None):
    """MSE loss and its gradients -> (loss, {leaf: grad}), on the scene's
    device; tile defaults to settings.ray_tile. The JAX package's scanned
    step: one refresh per step, then per tile the masked sum of squared
    errors and its backward pass, accumulated; both scaled by 1 / (R * 3).

    mesh: the tiles are shared out over its ranks. Whole zero-mask tiles
    pad the count to a multiple of the rank count D; rank i takes tiles
    [i n / D, (i + 1) n / D), each still drawing from fold_in(key, global
    tile index), and one all_reduce sums the loss and the grads before the
    scaling (raytracer_tpu/parallel/sharding.py:212-329)."""
    if mesh is not None:
        distributed.check_mesh(mesh)
    W, H = settings.width, settings.height
    R = W * H
    tile = tile or settings.ray_tile
    dev = scene.geom.vertices.device
    px, py, tgt, msk = _pixels(settings, target, dev)
    n_tiles = -(-R // tile)
    if mesh is not None:
        n_tiles += (-n_tiles) % mesh.size
    pad = n_tiles * tile - R
    if pad:
        px, py, msk = (torch.cat([x, x.new_zeros(pad)]) for x in (px, py, msk))
        tgt = torch.cat([tgt, tgt.new_zeros((pad, 3))])
    mine = range(n_tiles)
    if mesh is not None:
        n = n_tiles // mesh.size
        mine = range(mesh.rank * n, (mesh.rank + 1) * n)
    tiles = ((px[sl], py[sl], tgt[sl], msk[sl], rng.fold_in(key, ti))
             for ti in mine for sl in [slice(ti * tile, (ti + 1) * tile)])
    total, grads = _accumulate(params, _base(scene, params), cam, settings,
                               spp, tiles)
    return _finish(total, grads, R, mesh)


# The JAX package's host-loop variant of the same estimator; here the
# scanned step is a host loop already.
loss_and_grads_streamed = loss_and_grads_scanned


def loss_and_grads_geometry_sharded(params: dict, scene: Scene, cam: Camera,
                                    settings: RenderSettings, target,
                                    key: rng.Key, mesh, spp: int = 1):
    """loss_and_grads with the cluster table sharded over the mesh
    (raytracer_tpu/parallel/sharding.py:378-455): each rank refreshes its
    own shard from the current vertices under no_grad (the refresh is
    row-local: a gather from the replicated vertices), then traces its
    ray chunk round the ring (intersector 'ring'), with the keys of
    loss_and_grads; one all_reduce sums the loss and the grads."""
    mesh = distributed.check_mesh(mesh)
    if scene.clusters is None:
        raise ValueError('geometry sharding needs the cluster table')
    dev = scene.geom.vertices.device
    with torch.no_grad():
        g = scene.geom
        v = params['vertices'].detach()
        geom = dataclasses.replace(g, vertices=v,
                                   vertices_t1=g.vertices_t1 + (v - g.vertices))
        shard = refresh_clusters(ring.local_shard(scene.clusters, mesh), geom,
                                 scene.has_motion_blur)
    px, py, tgt, msk = (_chunk(x, mesh.size, mesh.rank)
                        for x in _pixels(settings, target, dev))
    total, grads = _accumulate(
        params, dataclasses.replace(scene, clusters=shard), cam,
        dataclasses.replace(settings, intersector='ring'), spp,
        [(px, py, tgt, msk, rng.fold_in(key, mesh.rank))])
    return _finish(total, grads, settings.width * settings.height, mesh)


def make_optimizer(params: dict, lr: float = 1e-3,
                   **kw) -> torch.optim.Adam:
    """torch.optim.Adam over the six leaves (optax.adam's defaults:
    betas (0.9, 0.999), eps 1e-8)."""
    return torch.optim.Adam([params[k] for k in PARAM_KEYS], lr=lr, **kw)


def train_step(params: dict, optimizer: torch.optim.Optimizer, scene: Scene,
               cam: Camera, settings: RenderSettings, target, key: rng.Key,
               spp: int = 1, tile: int | None = None, mesh=None):
    """One optimizer step of inverse rendering -> (params, loss): the
    scanned loss and gradients (tiles shared out over `mesh`), then
    `optimizer` (make_optimizer over these params) updates the leaves in
    place; every rank applies the same step to the same reduced grads."""
    loss, grads = loss_and_grads_scanned(params, scene, cam, settings,
                                         target, key, spp=spp, tile=tile,
                                         mesh=mesh)
    for k in PARAM_KEYS:
        params[k].grad = grads[k]
    optimizer.step()
    return params, loss
