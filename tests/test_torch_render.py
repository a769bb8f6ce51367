"""The port's renderer against the JAX package's, end to end.

The same scene (built by raytracer_tpu.SceneBuilder and carried across by
convert.py), the same camera and the same key go to both renderers.
Tolerance: at least 99% of pixels within atol 1e-4 + rtol 1e-3 on every
channel, and a mean |difference| below 1e-3 of the mean radiance. Both run
the same float32 estimator with the same random numbers, but sin, cos, pow
and rsqrt come from different libraries; one ulp can flip a grazing hit or
a sort bucket on a handful of pixels, which then take other samples.
"""
import os
import shutil
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

import raytracer_tpu as rj
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, jax_camera, jax_settings, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_images_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    within = (d <= 1e-4 + 1e-3 * np.abs(want)).all(-1)
    assert within.mean() >= 0.99, f'{within.mean():.4f} of pixels within'
    assert d.mean() < 1e-3 * np.abs(want).mean()
    assert want.mean() > 0


@pytest.fixture(scope='module')
def triangle_sphere():
    sj, cam, st = cpu(registry.triangle_sphere, size=24, builder=rj.SceneBuilder())
    return sj, to_port(sj), cam, st


@pytest.fixture(scope='module')
def sponza():
    """sponza_standin cut to 12 spheres, 32 x 24 pixels, 3 bounces."""
    sj, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3, n_spheres=12,
                                          builder=rj.SceneBuilder())
    return sj, to_port(sj), cam, st


@pytest.mark.parametrize('intersector', ['auto', 'brute'])
def test_render_center_triangle_sphere(triangle_sphere, intersector):
    sj, sp, cam, st = triangle_sphere
    want = jr.render_center(sj, jax_camera(cam),
                            jax_settings(st, intersector='brute'),
                            jax.random.PRNGKey(3))
    got = rt.render_center(sp, cam, replace(st, intersector=intersector),
                           rng.PRNGKey(3))
    _assert_images_close(got.numpy(), np.asarray(want))


def test_render_triangle_sphere(triangle_sphere):
    sj, sp, cam, st = triangle_sphere
    want = jr.render(sj, jax_camera(cam), jax_settings(st, intersector='brute'),
                     jax.random.PRNGKey(5), spp=2)
    got = rt.render(sp, cam, st, rng.PRNGKey(5), spp=2)
    _assert_images_close(got.numpy(), np.asarray(want))


def test_render_sponza_standin(sponza):
    """Path traced through the Pallas cluster kernel on the JAX side and
    the plain cluster tracer on the port's."""
    sj, sp, cam, st = sponza
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster_pallas'),
                     jax.random.PRNGKey(7))
    calls = ct.CALLS
    got = rt.render(sp, cam, st, rng.PRNGKey(7))
    assert ct.CALLS > calls
    _assert_images_close(got.numpy(), np.asarray(want))


def test_imports_without_jax(tmp_path):
    """The port builds a scene, renders (uniform and adaptive), takes a
    train step, adds the edge-sampled boundary terms, bakes the stone
    texture, builds and traces the BVH, runs the CLI and runs two ranks of
    parallel/worker.py (data-parallel and geometry-sharded) with jax,
    flax, optax and raytracer_tpu unimportable, from a copy of its package
    alone: no file of the JAX package is within reach, and the native
    library builds into the copy's own _build directory."""
    shutil.copytree(os.path.join(REPO, 'raytracer_tpu_torch'),
                    tmp_path / 'raytracer_tpu_torch',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    code = '\n'.join([
        'import os, sys',
        "for m in ('jax', 'flax', 'optax', 'raytracer_tpu'):",
        '    sys.modules[m] = None',
        'import numpy as np',
        'import torch',
        'import raytracer_tpu_torch as rt',
        'from raytracer_tpu_torch import native',
        'from raytracer_tpu_torch.core import rng',
        'from raytracer_tpu_torch.parallel import sharding',
        'from raytracer_tpu_torch.scenes import registry',
        'here = os.getcwd()',
        'assert rt.__file__.startswith(here) and native.SRC.startswith(here)',
        "scene, cam, st = registry.triangle_sphere(size=8, device='cpu')",
        'assert native.BUILD_DIR.startswith(here) and os.listdir(',
        '    native.BUILD_DIR)',
        'img = rt.render(scene, cam, st, rng.PRNGKey(0))',
        'assert img.shape == (8, 8, 3) and bool(img.isfinite().all())',
        'assert float(img.mean()) > 0',
        'params = sharding.get_params(scene)',
        'opt = sharding.make_optimizer(params, lr=1e-2)',
        'v0 = params["vertices"].clone()',
        'params, loss = sharding.train_step(params, opt, scene, cam, st,',
        '                                   torch.zeros(8, 8, 3),',
        '                                   rng.PRNGKey(1))',
        'assert bool(loss.isfinite()) and float(loss) > 0',
        'assert not torch.equal(params["vertices"], v0)',
        'from raytracer_tpu_torch.diff import edges',
        'from raytracer_tpu_torch.shading import procedural',
        'img2, cnt = rt.render_adaptive(scene, cam, st, rng.PRNGKey(2),',
        '                               with_counts=True)',
        'assert img2.shape == (8, 8, 3) and int(cnt.min()) == 1',
        'loss, g = edges.loss_and_grads_with_edges(',
        '    sharding.get_params(scene), scene, cam, st,',
        '    torch.zeros(8, 8, 3), rng.PRNGKey(3), edge_samples=64)',
        'assert bool(g["vertices"].isfinite().all())',
        'tex = procedural.bake_stone_texture(num_cells=4, size=4,',
        "                                    device='cpu')",
        'assert tex.shape == (4, 4, 3)',
        'import dataclasses',
        "scene, cam, st = registry.triangle_sphere(size=8, bvh=True,",
        "                                          device='cpu')",
        'assert scene.blas is not None',
        "img3 = rt.render(scene, cam, dataclasses.replace(",
        "    st, intersector='bvh'), rng.PRNGKey(0))",
        'assert bool((img3 - img).abs().max() < 1e-3)',
        'from raytracer_tpu_torch import cli',
        'from raytracer_tpu_torch.io import imageio',
        "assert cli.main(['--size', '8', '--spp', '1', '--device', 'cpu',",
        "                 '--out', 'frame.ppm']) == 0",
        "assert imageio.load_ppm('frame.ppm')[0].shape == (8, 8, 3)",
        'from raytracer_tpu_torch.parallel import worker',
        "res = worker.launch(2, ['--scene', 'triangle_sphere', '--scene-kw',",
        "                        '{\"size\": 8}', '--tasks',",
        "                        'render,step,render_geometry', '--tile',",
        "                        '16'], os.path.join(here, 'w.npz'),",
        "                    device='cpu')",
        'assert worker.PKG_ROOT == here',
        "assert res['render/img'].shape == (8, 8, 3)",
        "assert np.array_equal(res['render_geometry/img'], res['render/img'])",
        "assert not any(m.startswith(('jax', 'flax', 'optax',",
        "                             'raytracer_tpu.'))",
        '               for m in sys.modules if sys.modules[m] is not None)',
        "print('ok')"])
    # the worker's ranks start from the copy too (its directory first on
    # their path), where importing any of these packages raises
    for m in ('jax', 'flax', 'optax', 'raytracer_tpu'):
        (tmp_path / m).mkdir()
        (tmp_path / m / '__init__.py').write_text(
            f'raise RuntimeError("{m} imported")\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0 and res.stdout.strip() == 'ok', res.stderr
