"""The asset-free final forest in the port against the JAX package, on the
CPU.

* `final_forest_standin` at the JAX registry's defaults builds the counts
  the scene promises (200 + 4 trees, 100 flowers, a 40 x 40 grass grid,
  the motion-blurred partition), with deep tree prototypes (the
  hierarchical tracer) and flower and grass prototypes of at most 16
  clusters, so that n_trees=0 takes the segment tracer.
* The tracer routing of a two-level alpha scene with an opaque
  motion-blurred partition: the partition traced once through the cluster
  tracer in `mb` mode, the instances through the alpha march.
* A reduced render (three trees, 16 flowers, a 5 x 5 grass grid, 32 x 24
  pixels, 2 wavefront steps, one dome sample) against
  `raytracer_tpu.render` with intersector 'cluster2' (the Pallas kernels
  in interpret mode; their compile takes most of a minute): thin lens, 0.1
  shutter, alpha leaves, translucency, dispersion, env map and dome.
  Tolerance as tests/test_torch_render.py. The segment tracer's path
  (n_trees=0) is held to the Pallas kernel trace by trace in
  tests/test_torch_mb_alpha.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.render import renderer as jr
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core.types import RenderSettings
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.render import integrator as tint
from raytracer_tpu_torch.scenes import registry

from .test_torch_render import _assert_images_close
from .torch_port_util import cpu, jax_camera, jax_settings, to_port

SMALL = dict(width=32, height=24, n_flowers=16, grass_grid=5, max_bounces=1,
             dome_samples=1)


def test_full_size_counts():
    """The default scene: every instance, table and flag of the cell."""
    scene, cam, st = cpu(registry.final_forest_standin)
    icl = scene.iclusters
    # the world's static part, 204 trees, 100 flowers, 1,600 grass clumps
    assert icl.num_instances == 1 + 204 + 100 + 1600
    assert (st.width, st.height, st.max_wavefront_steps) == (1920, 1080, 7)
    assert not st.path_trace and scene.dome.num_samples == 2
    assert scene.has_alpha_maps and scene.has_motion_blur
    assert not scene.mb_has_alpha and scene.mb_clusters is not None
    assert scene.has_dispersion and scene.has_translucency
    assert float(scene.env_exposure) == 1.5
    assert float(scene.dome.gain) == pytest.approx(0.15)
    assert float(cam.shutter) == pytest.approx(0.1)
    lens = icl.pmeta[:, 1].tolist()          # clusters per prototype
    deep = [n for n in lens if n > 16]
    assert len(deep) == 2 and icl.max_proto_clusters == max(deep)
    assert scene.geom.face_mb.sum() > 0


def test_no_trees_takes_the_segment_tracer():
    scene, _, _ = cpu(registry.final_forest_standin, 8, 8, n_trees=0)
    assert scene.iclusters.max_proto_clusters <= 16
    assert scene.iclusters.num_instances == 1 + 100 + 1600


def test_routing_hoists_the_opaque_mb_partition():
    """Per trace: one `mb` launch of the partition, then the march's passes
    of the hierarchical tracer."""
    scene, cam, _ = cpu(registry.final_forest_standin, 16, 16, n_trees=2,
                                                  n_flowers=6, grass_grid=4)
    o, d, _ = tcam.center_rays(cam, 16, 16)
    tracer = tint.trace_fn(scene, RenderSettings())
    c0, i0, p0 = ct.CALLS, ict.CALLS, ct.MARCH_PASSES
    h = tracer(o, d, 0.95, 1e-3, 1e12, False)
    assert ct.CALLS - c0 == 1
    assert ict.CALLS - i0 == ct.MARCH_PASSES - p0 >= 2
    hit = h.tri >= 0
    assert hit.float().mean() > 0.2          # the sky is a miss
    # the march's hits are opaque
    from raytracer_tpu_torch.ops import intersect as tisect
    alpha = tisect.alpha_of(scene, h.tri.clamp(min=0), h.a, h.b)
    assert (alpha[hit] >= 0.5).all()
    with pytest.raises(NotImplementedError):
        tint.trace_fn(scene, RenderSettings(intersector='brute'))


def test_render_final_forest_matches_jax():
    n_trees = 3
    sj, cam, st = cpu(registry.final_forest_standin,
        builder=rj.SceneBuilder(), bvh=True, n_trees=n_trees, **SMALL)
    st = dataclasses.replace(st, max_wavefront_steps=2)
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster2'),
                     jax.random.PRNGKey(11))
    calls, mb_calls = ict.CALLS, ct.CALLS
    sp = to_port(sj)
    got = rt.render(sp, cam, st, rng.PRNGKey(11))
    assert ict.CALLS > calls and ct.CALLS > mb_calls
    _assert_images_close(got.numpy(), np.asarray(want))
    # the port's own build renders the very same image
    own, _, _ = cpu(registry.final_forest_standin, n_trees=n_trees, **SMALL)
    np.testing.assert_array_equal(
        rt.render(own, cam, st, rng.PRNGKey(11)).numpy(), got.numpy())
    assert isinstance(got, torch.Tensor)
