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


def render(scene: Scene, cam: Camera, settings: RenderSettings,
           key: rng.Key, spp: int = 1) -> torch.Tensor:
    """Uniform-spp render -> (H, W, 3) linear radiance on the scene's
    device (src/Camera.cpp:116-175 jitter, DOF and shutter draws)."""
    W, H = settings.width, settings.height
    dev = scene.geom.vertices.device
    px, py = cam_mod.pixel_coords(W, H, dev)
    R = W * H
    tile = min(settings.ray_tile, R + (-R) % settings.ray_tile)
    px = _pad(px, tile)
    py = _pad(py, tile)
    tiles = []
    for ti in range(px.shape[0] // tile):
        pxt = px[ti * tile:(ti + 1) * tile]
        pyt = py[ti * tile:(ti + 1) * tile]
        acc = torch.zeros((tile, 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            k = rng.fold_in(rng.fold_in(key, ti), s)
            k1, k2 = rng.split(k)
            rands = rng.uniform(k1, (tile, 5), dev)
            o, d, t = cam_mod.eye_rays(cam, W, H, pxt, pyt, 0.0, 1.0, 0.0,
                                       1.0, rands)
            acc = acc + integrator.radiance(scene, settings, o, d, t, k2)
        tiles.append(acc / spp)
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
