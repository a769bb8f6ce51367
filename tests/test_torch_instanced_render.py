"""The port's instanced renders against the JAX package's, end to end.

The same two-level scene (built by raytracer_tpu.SceneBuilder with its BVH,
carried across by convert.py), camera and key go to the JAX renderer with
intersector 'cluster2' (the Pallas segment or hierarchical kernel, in
interpret mode) and to the port's with 'auto' (the plain segment or
hierarchical tracer on the CPU). Tolerance as in tests/test_torch_render.py:
at least 99% of pixels within atol 1e-4 + rtol 1e-3 on every channel and a
mean |difference| below 1e-3 of the mean radiance.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import raytracer_tpu as rj
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.scenes import registry

from .test_torch_render import _assert_images_close
from .torch_port_util import cpu, jax_camera, jax_settings, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (builder, its arguments, the plain tracer the port takes)
SCENES = {
    'teapots': (registry.instanced_teapots_standin, {}, ist),
    'grid_400': (registry.instanced_grid_standin, dict(n=400), ist),
    'forest_12': (registry.forest_standin,
                  dict(n_trees=12, canopy=(30, 32)), ict),
}


@pytest.mark.parametrize('name', sorted(SCENES))
def test_render_center_matches_jax(name):
    make, kw, plain = SCENES[name]
    sj, cam, st = cpu(make, 48, 32, builder=rj.SceneBuilder(), bvh=True,
                      **kw)
    want = jr.render_center(sj, jax_camera(cam),
                            jax_settings(st, intersector='cluster2'),
                            jax.random.PRNGKey(3))
    calls = plain.CALLS
    got = rt.render_center(to_port(sj), cam, st, rng.PRNGKey(3))
    assert plain.CALLS > calls
    _assert_images_close(got.numpy(), np.asarray(want))
    # the port's own build (no BVH) renders the very same image
    own, cam2, st2 = cpu(make, 48, 32, **kw)
    np.testing.assert_array_equal(
        rt.render_center(own, cam2, st2, rng.PRNGKey(3)).numpy(),
        got.numpy())


def test_render_teapots_matches_jax():
    """Jittered eye rays and two samples per pixel."""
    sj, cam, st = cpu(registry.instanced_teapots_standin,
        32, 24, builder=rj.SceneBuilder(), bvh=True)
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster2'),
                     jax.random.PRNGKey(5), spp=2)
    got = rt.render(to_port(sj), cam, st, rng.PRNGKey(5), spp=2)
    _assert_images_close(got.numpy(), np.asarray(want))


def test_instanced_render_without_jax():
    """The port builds and renders both instanced paths, and the final
    forest (alpha march, motion blur, dome), with jax, flax and
    raytracer_tpu unimportable."""
    code = '\n'.join([
        'import sys',
        "for m in ('jax', 'flax', 'raytracer_tpu'):",
        '    sys.modules[m] = None',
        'import raytracer_tpu_torch as rt',
        'from raytracer_tpu_torch.core import rng',
        'from raytracer_tpu_torch.scenes import registry',
        'for make, kw in ((registry.instanced_teapots_standin, {}),',
        '                 (registry.forest_standin, dict(n_trees=8)),',
        '                 (registry.final_forest_standin, dict(',
        '                     n_trees=2, n_flowers=4, grass_grid=3,',
        '                     max_bounces=1))):',
        "    scene, cam, st = make(8, 8, device='cpu', **kw)",
        '    img = rt.render(scene, cam, st, rng.PRNGKey(0))',
        '    assert img.shape == (8, 8, 3) and bool(img.isfinite().all())',
        '    assert float(img.mean()) > 0',
        "assert not any(m.startswith(('jax', 'flax', 'raytracer_tpu.'))",
        '               for m in sys.modules if sys.modules[m] is not None)',
        "print('ok')"])
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == 'ok', res.stderr
