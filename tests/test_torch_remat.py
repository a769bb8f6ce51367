"""RenderSettings.remat in the port: each bounce step recomputed in the
backward pass (torch.utils.checkpoint, render/integrator._remat_step),
on the CPU.

* The remat step against the plain one, through
  `sharding.loss_and_grads_scanned`: the loss and all six leaves bit for
  bit (the replay is the forward pass again, and the CPU's `index_add` is
  deterministic), on the 12-sphere `sponza_standin` (opaque) and on
  `alpha_leaf_standin`, whose alpha march runs inside the step. The
  forward pass's counters are the plain step's, and the replay's
  (utils/counters.RECOMPUTE) the same again, one replay a step.
* The port's remat step against the JAX package's `remat=True` step
  (jax.checkpoint of its scan body) on the same scene, parameters and
  key, with tests/test_torch_train.py's tolerance: loss rtol 1e-5, each
  leaf rtol 1e-3 and atol 1e-4 x max|leaf|.
* `render` with remat on: the same image and the same launch counts as
  with it off, and no replay, with grad mode on (nothing requires grad)
  and off.
* `counters.reset` clears every counter `read` gives, the plain walks'
  box and triangle tests too, so that what an earlier module counted in
  the same process (tests/test_torch_group_walk.py) is not taken for the
  step's own counts.

The two-rank ring step with remat is a task of
tests/test_torch_sharding.py's `run` fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
import raytracer_tpu_torch as rt
from raytracer_tpu.parallel import sharding as js
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.utils import counters

from .torch_port_util import cpu, jax_camera, jax_settings, to_port

KEY = 3
SCENES = dict(
    sponza_12=lambda **kw: cpu(registry.sponza_standin, 32, 24,
                               max_bounces=3, n_spheres=12, **kw),
    alpha_leaf=lambda **kw: cpu(registry.alpha_leaf_standin, 24,
                                max_bounces=3, **kw))


def _step(scene, cam, st, remat, target=None):
    """(loss, grads, the forward pass's counters, the replay's) of one
    scanned step."""
    if target is None:
        target = torch.zeros((st.height, st.width, 3))
    counters.reset()
    loss, grads = ts.loss_and_grads_scanned(
        ts.get_params(scene), scene, cam,
        dataclasses.replace(st, remat=remat), target, rng.PRNGKey(KEY))
    return loss, grads, counters.read(), dict(counters.RECOMPUTE)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_remat_step_equals_plain_step(name):
    scene, cam, st = SCENES[name]()
    assert not st.remat
    loss, grads, fwd, replay = _step(scene, cam, st, False)
    loss_r, grads_r, fwd_r, replay_r = _step(scene, cam, st, True)
    assert torch.equal(loss_r, loss)
    for k in ts.PARAM_KEYS:
        assert torch.equal(grads_r[k], grads[k]), k
    assert float(grads['vertices'].abs().max()) > 0
    # the forward pass counts as without remat; each step it ran is
    # replayed once, whole
    assert fwd_r == fwd and not replay
    assert replay_r.pop('steps') > 0
    assert replay_r == {k: v for k, v in fwd.items() if v}
    assert fwd['calls.cluster_trace'] > 0
    if name == 'alpha_leaf':
        assert fwd['march_passes'] > fwd['calls.cluster_trace'] // 2 > 0


def test_remat_step_matches_jax_remat():
    sj, cam, st = SCENES['sponza_12'](builder=rj.SceneBuilder())
    st = dataclasses.replace(st, width=16, height=12, max_bounces=2,
                             max_wavefront_steps=2)
    sp = to_port(sj)
    target = np.random.default_rng(4).uniform(
        0, 0.5, (st.height, st.width, 3)).astype(np.float32)
    lj, gj = js.loss_and_grads_scanned(
        js.get_params(sj), sj, jax_camera(cam),
        jax_settings(st, intersector='cluster_pallas', remat=True),
        jnp.asarray(target), jax.random.PRNGKey(KEY), spp=1,
        tile=st.ray_tile)
    params = cpu(convert.params_from_arrays,
                 {k: np.asarray(v) for k, v in js.get_params(sj).items()})
    lt, gt = ts.loss_and_grads_scanned(
        params, sp, cam, dataclasses.replace(st, remat=True),
        torch.from_numpy(target), rng.PRNGKey(KEY), spp=1, tile=st.ray_tile)
    assert counters.RECOMPUTE['steps'] > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in ts.PARAM_KEYS:
        got, want = gt[k].numpy(), np.asarray(gj[k])
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    assert np.abs(gt['vertices'].numpy()).max() > 0


@pytest.mark.parametrize('grad_mode', [True, False])
def test_render_with_remat_is_the_plain_render(grad_mode):
    scene, cam, st = SCENES['sponza_12']()
    out = {}
    for remat in (False, True):
        counters.reset()
        with torch.set_grad_enabled(grad_mode):
            img = rt.render(scene, cam, dataclasses.replace(st, remat=remat),
                            rng.PRNGKey(KEY))
        out[remat] = img, counters.read(), dict(counters.RECOMPUTE)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    assert out[True][1]['calls.cluster_trace'] > 0
    assert not out[True][2] and not out[True][0].requires_grad


def test_reset_clears_an_earlier_walks_tests():
    scene, cam, st = SCENES['sponza_12']()
    ct.COUNT_TESTS = True
    try:
        rt.render(scene, cam, st, rng.PRNGKey(KEY))
    finally:
        ct.COUNT_TESTS = False
    assert ct.TESTS['box'] > 0 and ct.TESTS['tri'] > 0
    counters.reset()
    assert not any(counters.read().values())
