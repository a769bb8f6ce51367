"""Renders of the registry's single-level asset scenes, the port against
the JAX package, on the CPU, from one stand-in asset tree written to disk
(scenes/assets.write_tree; both registries pointed at it as in
tests/test_torch_asset_scenes.py).

Each scene is the port's own build from the tree (byte-equal to the JAX
build, tests/test_torch_asset_scenes.py) at 32 x 24 pixels and 2-3
bounces, rendered by `raytracer_tpu_torch.render` (the plain cluster
tracer) and by `raytracer_tpu.render` with intersector 'cluster_pallas'
(the Pallas kernel in interpret mode) on the same key. Tolerance as
tests/test_torch_render.py: at least 99% of pixels within atol 1e-4 +
rtol 1e-3, and a mean |difference| below 1e-3 of the mean radiance.
"""
import dataclasses

import jax
import numpy as np
import pytest

from raytracer_tpu.render import renderer as jr
from raytracer_tpu.scenes import registry as jreg
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.scenes import registry

from .test_torch_asset_scenes import point_at, tree  # noqa: F401
from .test_torch_render import _assert_images_close
from .torch_port_util import jax_camera, jax_settings

W, H = 32, 24
# the scene, its builder's arguments at test size, and the key
RENDERS = {
    'cornell_pt': (dict(size=W, max_bounces=2, num_rect_samples=2), 3),
    'alpha_leaf': (dict(size=W, max_bounces=2), 5),
    'dispersion': (dict(size=W, max_bounces=3, dome_samples=2), 7),
    'dome_teapot': (dict(size=W, dome_samples=2), 9),
    'mb_bullet': (dict(size=W), 11),
}


@pytest.mark.parametrize('name', sorted(RENDERS))
def test_render_matches_jax(tree, monkeypatch, name):
    point_at(monkeypatch, tree[0])
    kw, key = RENDERS[name]
    sj, _, _ = jreg.make(name, **kw)
    sp, cam, st = registry.make(name, device='cpu', **kw)
    st = dataclasses.replace(st, height=H)        # 32 x 24
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster_pallas'),
                     jax.random.PRNGKey(key))
    calls = ct.CALLS
    got = rt.render(sp, cam, st, rng.PRNGKey(key))
    assert ct.CALLS > calls
    _assert_images_close(got.numpy(), np.asarray(want))
