"""Renders of the registry's instanced asset scenes and of the flagship
`final_forest` both ways, the port against the JAX package, on the CPU,
from one stand-in asset tree written to disk (scenes/assets.write_tree;
both registries pointed at it as in tests/test_torch_asset_scenes.py).

Each scene is the port's own build from the tree (byte-equal to the JAX
build) at 32 x 24 pixels, rendered by `raytracer_tpu_torch.render` (the
plain tracers) and by `raytracer_tpu.render` (its Pallas kernels in
interpret mode) on the same key: `instanced_teapots` (the segment
tracer), `final_forest` with three trees, two flowers and a 2 x 2 grass
grid as two levels (the hierarchical instance tracer, the motion-blurred
partition through the cluster tracer in `mb` mode, the alpha march) and
flattened (single-level: the cluster tracer in `mb` mode under the alpha
march). Tolerance as tests/test_torch_render.py.
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
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.scenes import registry

from .test_torch_asset_scenes import point_at, tree  # noqa: F401
from .test_torch_render import _assert_images_close
from .torch_port_util import jax_camera, jax_settings

W, H = 32, 24
FOREST = dict(width=W, height=H, n_trees=3, n_flowers=2, grass_grid=2,
              max_bounces=1, dome_samples=1)
# the scene, its builder's arguments, the JAX intersector, the port's
# plain tracers that must carry it, and the key
RENDERS = {
    'instanced_teapots': ('instanced_teapots', dict(size=W, grid=3),
                          'cluster2', (ist,), 3),
    'final_forest': ('final_forest', FOREST, 'cluster2', (ict, ct), 11),
    'final_forest_flat': ('final_forest', dict(FOREST, flatten=True),
                          'cluster_pallas', (ct,), 13),
}


@pytest.mark.parametrize('case', sorted(RENDERS))
def test_render_matches_jax(tree, monkeypatch, case):
    point_at(monkeypatch, tree[0])
    name, kw, intersector, plains, key = RENDERS[case]
    sj, _, _ = jreg.make(name, **kw)
    sp, cam, st = registry.make(name, device='cpu', **kw)
    st = dataclasses.replace(st, height=H, max_wavefront_steps=2)
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector=intersector),
                     jax.random.PRNGKey(key))
    calls = [m.CALLS for m in plains]
    got = rt.render(sp, cam, st, rng.PRNGKey(key))
    assert all(m.CALLS > c for m, c in zip(plains, calls))
    _assert_images_close(got.numpy(), np.asarray(want))
    assert sp.single_level == (case == 'final_forest_flat')
