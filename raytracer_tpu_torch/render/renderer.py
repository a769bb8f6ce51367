"""Image-level render loops.

Port of raytracer_tpu/render/renderer.py: the image is flattened to a
padded ray array and rendered tile by tile, each tile averaging `spp`
jittered samples. The keys follow the JAX package exactly
(fold_in(fold_in(key, tile), sample), then split), so a key renders the
same image on both. `render_adaptive` is the JAX package's adaptive
progressive supersampling, chunk for chunk.
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


ADAPTIVE_CHUNK = 1024


def adaptive_chunk(tile: int) -> int:
    """The adaptive render's chunk: the largest divisor of the tile up to
    ADAPTIVE_CHUNK, so chunks cover a tile exactly."""
    return max(c for c in range(1, min(ADAPTIVE_CHUNK, tile) + 1)
               if tile % c == 0)


def render_adaptive(scene: Scene, cam: Camera, settings: RenderSettings,
                    key: rng.Key, with_counts: bool = False):
    """Adaptive progressive supersampling (Scene::adaptiveSampleScene,
    src/Scene.cpp:250-293) -> (H, W, 3), and the (H, W) int32 sample
    counts with with_counts=True.

    Levels k = 2..max_subdivs add k^2 stratified samples to every pixel
    still active; from min_subdivs on, a pixel stops when the max-channel
    change of its gamma-space value drops below noise_threshold. As in the
    JAX package, each tile renders in chunks of CH pixels (the largest
    divisor of the tile up to ADAPTIVE_CHUNK, `adaptive_chunk`), each
    chunk an integrator wavefront of its own with the sample's key; before
    each level the active pixels are compacted to the front (a stable sort
    of the mask) and only the chunks that hold them are rendered. The
    integrator's random numbers depend on a chunk's make-up, so the chunks
    are the JAX package's. The JAX while_loop is a host loop whose trip
    count is read once per level, and a level's chunks go to the
    integrator in one call (radiance's `segment`), which traces each as it
    would alone. Not differentiable; training uses `render`."""
    W, H = settings.width, settings.height
    dev = scene.geom.vertices.device
    px, py = cam_mod.pixel_coords(W, H, dev)
    R = W * H
    tile = min(settings.ray_tile, R + (-R) % settings.ray_tile)
    px = _pad(px, tile)
    py = _pad(py, tile)
    CH = adaptive_chunk(tile)
    # chunks go to the integrator together, as wavefronts of CH rays laid
    # end to end, except in scenes with alpha maps (whose march budgets by
    # the wavefront's size): there one chunk a call
    segment, step = (None, CH) if scene.has_alpha_maps else (CH, tile)
    imgs, counts_all = [], []
    for ti in range(px.shape[0] // tile):
        pxt = px[ti * tile:(ti + 1) * tile]
        pyt = py[ti * tile:(ti + 1) * tile]
        kt = rng.fold_in(key, ti)

        def sample_ids(ids, lo_x, hi_x, lo_y, hi_y, kcell):
            """One stratified sample for the pixels `ids`, CH at a time:
            pixel i draws its jitter from fold_in(kcell, i), and each run
            of CH pixels is one integrator wavefront keyed kcell."""
            rands = rng.uniform(rng.fold_in(kcell, ids), (5,))
            o, d, t = cam_mod.eye_rays(cam, W, H, pxt[ids], pyt[ids],
                                       lo_x, hi_x, lo_y, hi_y, rands)
            return integrator.radiance(scene, settings, o, d, t, kcell,
                                       segment=segment)

        # level 1: one centre sample for every pixel
        ids = torch.arange(tile, device=dev)
        result = torch.cat([sample_ids(ids[c:c + step], 0.5, 0.5, 0.5, 0.5,
                                       rng.fold_in(kt, 0))
                            for c in range(0, tile, step)])
        active = torch.ones(tile, dtype=torch.bool, device=dev)
        counts = torch.ones(tile, dtype=torch.int32, device=dev)

        for level in range(2, settings.max_subdivs + 1):
            kl = rng.fold_in(kt, level)
            # sums of squares 1..level-1 (src/Scene.cpp:245-248)
            n_pre = (level - 1) * level * (2 * level - 1) / 6.0
            n_now = level * level
            off = 1.0 / level
            # compact: active pixels first, in raster order; the chunks
            # that hold them (one host sync a level)
            order = torch.argsort((~active).to(torch.int8), stable=True)
            n_act = CH * -(-int(active.sum()) // CH)
            for c in range(0, n_act, step):
                ids = order[c:min(c + step, n_act)]
                upd = active[ids]
                cur = torch.zeros((ids.shape[0], 3), dtype=torch.float32,
                                  device=dev)
                for i in range(level):
                    for j in range(level):
                        cur = cur + sample_ids(
                            ids, i * off, (i + 1) * off, j * off,
                            (j + 1) * off, rng.fold_in(kl, i * level + j))
                old = result[ids]
                new = (old * n_pre + cur) / (n_pre + n_now)
                delta = (vm.linear_to_gamma_f(old)
                         - vm.linear_to_gamma_f(new)).abs()
                converged = delta.amax(-1) < settings.noise_threshold
                result[ids] = torch.where(upd[:, None], new, old)
                counts[ids] += torch.where(upd, n_now, 0).to(torch.int32)
                if level >= settings.min_subdivs:
                    active[ids] = upd & ~converged
        imgs.append(result)
        counts_all.append(counts)
    img = torch.cat(imgs)[:R].reshape(H, W, 3)
    if with_counts:
        return img, torch.cat(counts_all)[:R].reshape(H, W)
    return img


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Linear radiance -> gamma 8-bit (the reference Image::Map tone map)."""
    return vm.tone_map_u8(img)
