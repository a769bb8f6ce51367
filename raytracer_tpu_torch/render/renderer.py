"""Image-level render loops.

Port of raytracer_tpu/render/renderer.py: the image is flattened to a
padded ray array and rendered tile by tile, each tile averaging `spp`
jittered samples. The keys follow the JAX package exactly
(fold_in(fold_in(key, tile), sample), then split), so a key renders the
same image on both. Adaptive sampling is not ported yet (ROADMAP queue 1
#11).
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.types import Scene, Camera, RenderSettings
from . import camera as cam_mod
from . import integrator


def _pad(x, tile):
    pad = (-x.shape[0]) % tile
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x


def render_pixels(scene: Scene, cam: Camera, settings: RenderSettings,
                  spp: int, px, py, key: rng.Key) -> torch.Tensor:
    """Radiance of pixels (px, py), each the mean of `spp` jittered
    samples -> (n, 3): sample s draws from fold_in(key, s), split into the
    camera's and the integrator's keys (the JAX package's per-tile body,
    raytracer_tpu/parallel/sharding.py:_render_local)."""
    n = px.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=px.device)
    for s in range(spp):
        k1, k2 = rng.split(rng.fold_in(key, s))
        rands = rng.uniform(k1, (n, 5), px.device)
        o, d, t = cam_mod.eye_rays(cam, settings.width, settings.height, px,
                                   py, 0.0, 1.0, 0.0, 1.0, rands)
        acc = acc + integrator.radiance(scene, settings, o, d, t, k2)
    return acc / spp


def render(scene: Scene, cam: Camera, settings: RenderSettings,
           key: rng.Key, spp: int = 1) -> torch.Tensor:
    """Uniform-spp render -> (H, W, 3) linear radiance on the scene's
    device (src/Camera.cpp:116-175 jitter, DOF and shutter draws); tile ti
    renders with fold_in(key, ti)."""
    W, H = settings.width, settings.height
    dev = scene.geom.vertices.device
    px, py = cam_mod.pixel_coords(W, H, dev)
    R = W * H
    tile = min(settings.ray_tile, R + (-R) % settings.ray_tile)
    px = _pad(px, tile)
    py = _pad(py, tile)
    tiles = [render_pixels(scene, cam, settings, spp,
                           px[ti * tile:(ti + 1) * tile],
                           py[ti * tile:(ti + 1) * tile],
                           rng.fold_in(key, ti))
             for ti in range(px.shape[0] // tile)]
    return torch.cat(tiles)[:R].reshape(H, W, 3)


def render_center(scene: Scene, cam: Camera, settings: RenderSettings,
                  key: rng.Key) -> torch.Tensor:
    """Deterministic center-of-pixel render (the reference eyeRay path)."""
    W, H = settings.width, settings.height
    o, d, t = cam_mod.center_rays(cam, W, H)
    return integrator.radiance(scene, settings, o, d, t, key).reshape(H, W, 3)


def render_adaptive(*args, **kwargs):
    raise NotImplementedError('adaptive sampling: ROADMAP queue 1 #11')


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Linear radiance -> gamma 8-bit (the reference Image::Map tone map)."""
    return vm.tone_map_u8(img)
