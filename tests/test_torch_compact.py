"""The bounce loop on the live rays only (render/integrator.radiance).

After the first bounce step, radiance() runs each step on the sorted
wavefront's live prefix and carries the dead rows over. These tests hold
it to the loop that runs every step on the whole wavefront, written out
here as a loop of integrator._step: the image bit for bit (a closed scene
whose rays die over several bounces, an alpha-map scene with the dome, a
motion-blurred one), a training step's six gradient leaves within
tests/test_torch_train.py's tolerance, the alpha march on a prefix against
the march on the whole wavefront where its pass budget binds, and the
lights' and the step's random numbers on a prefix against the whole
wavefront's. No JAX here: the reference is the port's own whole-wavefront
loop, which the JAX comparisons of the other test_torch_* files hold.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import integrator, renderer
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.shading import lights

from .torch_port_util import cpu

KEY = 7


def whole_wavefront_radiance(scene, settings, o, d, time, base_key,
                             kind0=integrator.KIND_PRIMARY, prev_mat0=0,
                             gi_bounces0=0, segment=None):
    """radiance() with every bounce step over all R rows: the loop as it
    ran before steps ran on the live prefix."""
    tracer = integrator.trace_fn(scene, settings)
    state = integrator.initial_state(o, d, time, kind0, prev_mat0,
                                     gi_bounces0)
    for step_idx in range(settings.max_wavefront_steps):
        if not bool(state['alive'].any()):
            break
        state = integrator._step(scene, settings, tracer, state, step_idx,
                                 base_key, segment)
    return integrator.final_radiance(state, settings)


def _rows_run(monkeypatch):
    """Record the rows each bounce step runs on -> the list it fills."""
    rows, step = [], integrator._step

    def watched(sc, settings, tracer, state, *a, **kw):
        rows.append(state['o'].shape[0])
        return step(sc, settings, tracer, state, *a, **kw)
    monkeypatch.setattr(integrator, '_step', watched)
    return rows


def _path_traced(built):
    """A Whitted fixture path traced over three bounces."""
    scene, cam, st = built
    return scene, cam, dataclasses.replace(
        st, path_trace=True, max_bounces=3, max_wavefront_steps=5)


FIXTURES = {
    # path traced: rays die over the bounces as they miss or stop; four
    # rect light samples a hit, so the lights' draws beyond the first
    # sample reach the image
    'closed': lambda: cpu(registry.sponza_standin, 32, 24, max_bounces=4,
                          n_spheres=12, rect_samples=4),
    # alpha-cut leaves (the march), the HDR dome, motion blur, two levels
    'alpha_dome': lambda: cpu(registry.final_forest_standin, 32, 24,
                              n_trees=4, n_flowers=20, grass_grid=8,
                              max_bounces=3),
    'motion_blur': lambda: _path_traced(cpu(registry.mb_bullet_standin, 24)),
}


@pytest.mark.parametrize('name', list(FIXTURES))
def test_image_equals_the_whole_wavefront_loop(name, monkeypatch):
    scene, cam, st = FIXTURES[name]()
    key = rng.PRNGKey(KEY)
    rows = _rows_run(monkeypatch)
    img = renderer.render(scene, cam, st, key)
    ran, rows[:] = list(rows), []
    with monkeypatch.context() as m:
        m.setattr(integrator, 'radiance', whole_wavefront_radiance)
        want = renderer.render(scene, cam, st, key)
    full = list(rows)
    assert torch.isfinite(img).all() and float(img.abs().max()) > 0
    assert torch.equal(img, want), \
        f'{int((img != want).any(-1).sum())} pixels differ'
    # the same steps ran, the later ones on fewer rows, in blocks
    tile = full[0]
    assert len(ran) == len(full) >= 3 and ran[0] == tile
    assert set(full) == {tile} and min(ran) < tile
    assert all(r % integrator.LIVE_BLOCK == 0 or r == tile for r in ran)


def test_train_step_grads_match_the_whole_wavefront_loop(monkeypatch):
    """A 3-bounce step on the 12-sphere atrium: the loss and all six
    leaves against the whole-wavefront loop's, within rtol 1e-3 and atol
    1e-4 x max|leaf| (tests/test_torch_train.py's rule)."""
    scene, cam, st = cpu(registry.sponza_standin, 32, 24, max_bounces=3,
                         n_spheres=12)
    params = ts.get_params(scene)
    rs = np.random.default_rng(4)
    target = torch.from_numpy(
        rs.uniform(0, 0.5, (st.height, st.width, 3)).astype(np.float32))
    rows = _rows_run(monkeypatch)

    def step():
        return ts.loss_and_grads_scanned(params, scene, cam, st, target,
                                         rng.PRNGKey(KEY))
    loss, grads = step()
    assert min(rows) < rows[0]
    with monkeypatch.context() as m:
        m.setattr(integrator, 'radiance', whole_wavefront_radiance)
        loss_w, grads_w = step()
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    assert set(grads) == set(ts.PARAM_KEYS)
    for k in ts.PARAM_KEYS:
        got, want = grads[k].numpy(), grads_w[k].numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(grads['vertices'].abs().max()) > 0


def test_alpha_march_on_a_prefix_budgets_by_the_wavefront():
    """32,768 rays, the last half dead (tmax < 0), aimed at the two leaf
    cards, two passes: pass 1 retraces max(4096, 32768 >> 2) = 8,192
    rows of the live-first partition. The march on the live half inside
    march_rows(32768) gives the whole wavefront's hits bit for bit;
    outside it, its pass 1 budgets by 16,384 rows (4,096), fewer than the
    live rays waiting, and the hits differ."""
    scene, _, _ = cpu(registry.alpha_leaf_standin, 16)
    opaque = dataclasses.replace(scene, has_alpha_maps=False)
    R, n = 32768, 16384
    rs = np.random.default_rng(10)
    tgt = np.stack([rs.uniform(-3.2, 0.2, R), rs.uniform(-1.2, 1.7, R),
                    np.zeros(R)], -1)
    o = np.asarray([-1.5, 0.25, 4.0]) + rs.normal(size=(R, 3)) * 0.2
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    tmax = torch.full((R,), 1e12)
    tmax[n:] = -1.0
    traced = []

    def trace(o, d, time, tmin, tmax, any_hit):
        traced.append(o.shape[0])
        return isect.brute_force_trace(opaque, o, d, time, tmin, tmax, False)

    def march(k):
        traced.clear()
        h = ct.alpha_aware_trace(scene, trace, o[:k], d[:k], 0.0, 1e-3,
                                 tmax[:k], False, 2)
        return h, list(traced)
    whole, t_whole = march(R)
    with ct.march_rows(R):
        prefix, t_prefix = march(n)
    alone, t_alone = march(n)
    assert t_whole == [R, 8192] and t_prefix == [n, 8192] \
        and t_alone == [n, 4096]
    for f in ('t', 'tri', 'inst', 'a', 'b'):
        assert torch.equal(getattr(prefix, f), getattr(whole, f)[:n]), f
    # the budget binds: more rays wait after pass 0 than 4,096
    first = ct.alpha_aware_trace(scene, trace, o[:n], d[:n], 0.0, 1e-3,
                                 tmax[:n], False, 1)
    cut = isect.alpha_of(scene, first.tri.clamp(min=0), first.a, first.b)
    waiting = int(((first.tri >= 0) & (cut < 0.5)).sum())
    assert waiting > 4096
    assert not torch.equal(alone.tri, whole.tri[:n])


def test_every_march_of_a_render_budgets_by_the_wavefront(monkeypatch):
    """In a render of the alpha-map scene, every alpha march, of a path
    trace and of a dome shadow trace alike, budgets by the tile's rows,
    also where a step gives it only the live prefix."""
    scene, cam, st = FIXTURES['alpha_dome']()
    calls, march = [], ct.alpha_aware_trace

    def watched(sc, once, o, d, time, tmin, tmax, any_hit=False, *a, **kw):
        calls.append((o.shape[0], ct.MARCH_ROWS, any_hit))
        return march(sc, once, o, d, time, tmin, tmax, any_hit, *a, **kw)
    monkeypatch.setattr(ct, 'alpha_aware_trace', watched)
    renderer.render(scene, cam, st, rng.PRNGKey(KEY))
    tile = calls[0][0]
    assert all(rows == tile for _, rows, _ in calls)
    assert {any_hit for k, _, any_hit in calls if k < tile} == {False, True}


def test_prefix_draws_are_the_wavefront_draws():
    """A (n, k) draw is the first n rows of a (R, k) draw (flat counters);
    a (samples, n, 2) draw is not the [:, :n] slice of (samples, R, 2)."""
    key = rng.PRNGKey(5)
    R, n = 1024, 300
    for k in (2, 3, 5):
        assert torch.equal(rng.uniform(key, (n, k)),
                           rng.uniform(key, (R, k))[:n])
    assert not torch.equal(rng.uniform_segmented(key, (4, n, 2), None, 1),
                           rng.uniform_segmented(key, (4, R, 2), None, 1)
                           [:, :n])


@pytest.mark.parametrize('name', ['rect', 'dome'])
def test_lights_on_a_prefix_draw_the_wavefront_samples(name):
    """sample_all_lights on the first n of R shading points with rows=R
    gives those points' light samples of the call on all R, bit for bit:
    each light's samples are the [:, :n] slice of its (samples, R, 2)
    draw. Without rows they are another draw."""
    if name == 'rect':
        scene, _, st = cpu(registry.sponza_standin, 16, 16, max_bounces=2,
                           n_spheres=12, rect_samples=4)
    else:
        scene, _, st = cpu(registry.dome_standin, 16)
    tracer = integrator.trace_fn(scene, st)
    R, n = 1024, 512
    rs = np.random.default_rng(2)
    lo = scene.geom.vertices.amin(0).numpy()
    hi = scene.geom.vertices.amax(0).numpy()
    P = lo + (hi - lo) * rs.uniform(0.1, 0.9, (R, 3))
    N = rs.normal(size=(R, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    rvec = rs.normal(size=(R, 3))
    rvec /= np.linalg.norm(rvec, axis=-1, keepdims=True)
    P, N, rvec = (torch.from_numpy(x.astype(np.float32)) for x in (P, N, rvec))
    exp = torch.full((R,), 20.0)
    active = torch.from_numpy(rs.uniform(size=R) < 0.8)
    secondary = torch.from_numpy(rs.uniform(size=R) < 0.5)
    key = rng.PRNGKey(KEY)

    def call(k, **kw):
        return lights.sample_all_lights(
            scene, tracer, P[:k], N[:k], rvec[:k], exp[:k], 0.0, key, False,
            st, want_back=True, active=active[:k],
            secondary_mask=secondary[:k], **kw)
    whole = call(R)
    prefix = call(n, rows=R)
    alone = call(n)
    assert float(whole[0].abs().max()) > 0
    for got, want in zip(prefix, whole):
        assert torch.equal(got, want[:n])
    assert not torch.equal(alone[0], whole[0][:n])
