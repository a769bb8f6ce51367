"""Adaptive supersampling (render/renderer.render_adaptive) in the port
against the JAX package's, on the CPU.

The 12-sphere `sponza_standin` at 16x12, path-traced with 2 bounces, in
two 96-ray tiles (the second one padded) of one chunk each, levels 1-3
with convergence decided from level 2 on: the image within the
frame rule of tests/test_torch_render.py (>= 99% of pixels within 1e-4 +
1e-3 |x|, mean relative difference < 1e-3) and the per-pixel sample
counts equal on >= 99% of pixels. Both packages draw each chunk's
integrator numbers from the chunk's own key, so the chunks and their
order must be the JAX package's; the JAX side traces with 'brute'. The
port hands a level's chunks to the integrator in one call (radiance's
`segment`), which must trace each chunk exactly as a call of its own
does: the random numbers, the wavefront sort and so the radiance bit for
bit, which tiles of several chunks check against one call per chunk.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.render import renderer as jr
from raytracer_tpu_torch import render_adaptive
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.render import renderer as tr
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, jax_camera, jax_settings, to_port

ADAPTIVE = dict(ray_tile=96, min_subdivs=2, max_subdivs=3,
                noise_threshold=0.05)


def _sponza(builder=None):
    return cpu(registry.sponza_standin, 16, 12, max_bounces=2, n_spheres=12,
               builder=builder)


@pytest.fixture(scope='module')
def sponza():
    sj, _, _ = _sponza(rj.SceneBuilder())
    _, cam, st = _sponza()
    return sj, to_port(sj), cam, dataclasses.replace(st, **ADAPTIVE)


def test_render_adaptive_matches_jax(sponza):
    sj, sp, cam, st = sponza
    img_j, cnt_j = jr.render_adaptive(
        sj, jax_camera(cam), jax_settings(st, intersector='brute'),
        jax.random.PRNGKey(3), with_counts=True)
    img_j, cnt_j = np.asarray(img_j), np.asarray(cnt_j)
    img, cnt = render_adaptive(sp, cam, st, rng.PRNGKey(3),
                               with_counts=True)
    assert img.shape == (12, 16, 3) and cnt.shape == (12, 16)
    assert cnt.dtype == torch.int32 and bool(torch.isfinite(img).all())
    img, cnt = img.numpy(), cnt.numpy()
    # some pixels stopped after level 2, some took level 3 too
    assert set(np.unique(cnt_j)) == {5, 14}
    assert (cnt == cnt_j).mean() >= 0.99
    diff = np.abs(img - img_j)
    assert (diff <= 1e-4 + 1e-3 * np.abs(img_j)).all(-1).mean() >= 0.99
    assert diff.mean() / np.abs(img_j).mean() < 1e-3


def test_segmented_radiance_is_chunk_by_chunk(sponza):
    """radiance over four 64-ray wavefronts laid end to end, with
    segment=64, equals four calls of 64 rays each, bit for bit."""
    from raytracer_tpu_torch.render import camera as cam_mod
    from raytracer_tpu_torch.render import integrator

    _, sp, cam, st = sponza
    px, py = cam_mod.pixel_coords(16, 16)
    rands = rng.uniform(rng.PRNGKey(5), (256, 5))
    o, d, t = cam_mod.eye_rays(cam, 16, 16, px, py, 0.0, 1.0, 0.0, 1.0,
                               rands)
    key = rng.PRNGKey(6)
    whole = integrator.radiance(sp, st, o, d, t, key, segment=64)
    parts = torch.cat([integrator.radiance(sp, st, o[c:c + 64],
                                           d[c:c + 64], t[c:c + 64], key)
                       for c in range(0, 256, 64)])
    assert torch.equal(whole, parts)
    assert not torch.equal(whole, integrator.radiance(sp, st, o, d, t, key))
    with pytest.raises(ValueError, match='multiple'):
        integrator.radiance(sp, st, o[:100], d[:100], t[:100], key,
                            segment=64)


def test_adaptive_batched_chunks_match_chunk_calls(sponza):
    """The batched chunks against one integrator call per chunk (the path
    of scenes with alpha maps, taken here by a scene that claims alpha
    maps and has none: its alpha march accepts every first hit)."""
    _, sp, cam, st = sponza
    st = dataclasses.replace(st, width=8, height=8, ray_tile=64,
                             max_bounces=1, max_wavefront_steps=3)
    calls = dataclasses.replace(sp, has_alpha_maps=True)
    old = tr.ADAPTIVE_CHUNK
    try:
        tr.ADAPTIVE_CHUNK = 32       # two chunks to the 64-pixel tile
        img, cnt = render_adaptive(sp, cam, st, rng.PRNGKey(7),
                                   with_counts=True)
        img2, cnt2 = render_adaptive(calls, cam, st, rng.PRNGKey(7),
                                     with_counts=True)
    finally:
        tr.ADAPTIVE_CHUNK = old
    assert torch.equal(img, img2) and torch.equal(cnt, cnt2)
    assert set(np.unique(cnt.numpy())) == {5, 14}


@pytest.mark.parametrize('tile,chunk', [(96, 96), (1024, 1024),
                                        (1280, 640), (1 << 21, 1024),
                                        (1031, 1)])
def test_adaptive_chunk(tile, chunk):
    assert tr.adaptive_chunk(tile) == chunk


@pytest.mark.parametrize('threshold,counts', [(1e9, {5}), (-1.0, {14})])
def test_adaptive_counts_follow_the_threshold(threshold, counts):
    """Every pixel stops after level 2 when any change counts as
    converged, and none does when none can; with max_subdivs=1 every
    pixel takes its one centre sample, and the image alone comes back."""
    sp, cam, st = cpu(registry.triangle_sphere, size=8)
    st = dataclasses.replace(st, **dict(ADAPTIVE, ray_tile=48,
                                        noise_threshold=threshold))
    img, cnt = render_adaptive(sp, cam, st, rng.PRNGKey(4),
                               with_counts=True)
    assert set(np.unique(cnt.numpy())) == counts
    one = render_adaptive(sp, cam, dataclasses.replace(st, max_subdivs=1),
                          rng.PRNGKey(4))
    assert isinstance(one, torch.Tensor) and one.shape == img.shape
    assert float(one.mean()) > 0
