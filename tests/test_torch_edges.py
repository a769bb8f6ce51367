"""Edge-sampled visibility gradients (diff/edges.py) in the port against the
JAX package's, on the CPU.

The JAX scenes are the JAX package's own edge-gradient fixtures
(tests/test_edge_grad.py: one bright triangle, three instances of a
one-triangle prototype, an off-frame blocker's hard shadow, and a floor
lit only by one-bounce GI past an off-frame blocker, all 32x32), carried
across with convert; `triangle_sphere` adds a closed mesh. The JAX side
traces with its plain references, 'brute' (single-level) and 'bvh'
(instanced), the port with its plain cluster tracers; both find the same
nearest hits.

* The edge tables, and the instanced (instance, edge) pair table, of the
  port's own build are byte-equal to the JAX build's.
* `_project` and `_screen_ray` agree within 1e-5 px, and the analytic
  screen Jacobian with jax.jacfwd within rtol 1e-5.
* The edge CDF: the port's (a float64 running sum, the same on the CPU
  and the card) and jnp.cumsum's (float32) differ in the last bits, so a
  sample within that difference of a CDF step may pick the neighbouring
  edge; on the main path's 280,942 edge weights every disagreement is
  such a sample. On the fixtures every sample picks the same edge.
* Each estimator, and `loss_and_grads_with_edges`, on the same key and
  the same adjoint or target: every vertex gradient within rtol 1e-3 and
  atol 1e-4 x max|grad| (the rule of tests/test_torch_train.py; both sum
  the same float32 terms in other orders).
* `integrator.radiance` restarted mid-path as a GI ray (kind0=KIND_GI,
  per-ray prev_mat0, gi_bounces0=1) matches the JAX function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.diff import edges as je
from raytracer_tpu.parallel import sharding as js
from raytracer_tpu.render import integrator as jint
from raytracer_tpu_torch import SceneBuilder
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.diff import edges as te
from raytracer_tpu_torch.geometry import build as tbuild
from raytracer_tpu_torch.io.objload import make_single_triangle
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import integrator as tint
from raytracer_tpu_torch.scenes import registry

from . import test_edge_grad as fx
from .torch_port_util import (cpu, jax_camera, jax_settings, port_camera,
                              port_settings, to_port)

KEY = 11


def _close(got, want, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                               err_msg=what)


# ------------------------------------------------------ the port's builds
def _port_tri():
    """tests/test_edge_grad.py:_tri_scene, built by the port."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.add_mesh(make_single_triangle((-1.0, -1.0, 0.0), (1.0, -1.0, 0.0),
                                    (0.0, 1.0, 0.0), n=(0, 0, 1)), lam)
    b.add_point_light((0, 0, 5), 300.0, cast_shadows=False)
    b.set_bg_color((0.0, 0.0, 0.0))
    return b.build(device='cpu')


def _port_inst_tri():
    """tests/test_edge_grad.py:_inst_tri_scene, built by the port."""
    b = SceneBuilder()
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.begin_prototype()
    b.add_mesh(make_single_triangle((-0.6, -0.6, 0.0), (0.6, -0.6, 0.0),
                                    (0.0, 0.6, 0.0), n=(0, 0, 1)), lam)
    proto = b.end_prototype()
    for tx, s in ((-1.3, 1.0), (0.0, 0.8), (1.3, 1.2)):
        b.add_instance(proto, np.asarray([[s, 0, 0, tx], [0, s, 0, 0],
                                          [0, 0, 1, 0]], np.float32))
    b.add_point_light((0, 0, 6), 300.0, cast_shadows=False)
    b.set_bg_color((0.0, 0.0, 0.0))
    return b.build(device='cpu')


PORT_BUILDS = {
    'tri': (lambda: fx._tri_scene()[0], _port_tri),
    'inst_tri': (lambda: fx._inst_tri_scene()[0], _port_inst_tri),
    'triangle_sphere': (
        lambda: cpu(registry.triangle_sphere, size=8,
                    builder=rj.SceneBuilder())[0],
        lambda: cpu(registry.triangle_sphere, size=8)[0]),
}


@pytest.mark.parametrize('name', sorted(PORT_BUILDS))
def test_edge_tables_byte_equal(name):
    make_j, make_t = PORT_BUILDS[name]
    ej, et = make_j().edges, make_t().edges
    for f in ('vid', 'fid', 'pair_inst', 'pair_edge'):
        a, b = getattr(ej, f), getattr(et, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    if name == 'inst_tri':
        assert et.pair_inst.shape == (9,)      # 3 instances x 3 edges
    if name == 'tri':
        assert (et.fid[:, 1] == -1).all()      # one triangle: open edges


def test_pair_cap_drops_the_table(monkeypatch):
    """Beyond the pair cap an instanced scene carries no edge table, and
    the edge trainer says why."""
    monkeypatch.setattr(tbuild, 'PAIR_CAP', 8)
    scene = _port_inst_tri()
    assert scene.edges is None
    with pytest.raises(ValueError, match='scene.edges'):
        te.loss_and_grads_with_edges(ts.get_params(scene), scene, None,
                                     None, None, rng.PRNGKey(0))


# ------------------------------------------------------- the JAX fixtures
@pytest.fixture(scope='module')
def cases():
    """name -> (JAX scene, JAX camera, JAX settings with the JAX tracer,
    port scene, port camera, port settings)."""
    out = {}
    for name, make, jmode in (('tri', fx._tri_scene, 'brute'),
                              ('inst_tri', fx._inst_tri_scene, 'bvh'),
                              ('blocker', fx._blocker_scene, 'brute'),
                              ('gi_blocker', fx._gi_blocker_scene, 'brute')):
        sj, cj, stj = make()
        out[name] = (sj, cj, stj.replace(intersector=jmode), to_port(sj),
                     port_camera(cj), port_settings(stj))
    sp, cam, st = cpu(registry.triangle_sphere, size=24)
    sj, _, _ = cpu(registry.triangle_sphere, size=24,
                   builder=rj.SceneBuilder())
    out['triangle_sphere'] = (sj, jax_camera(cam),
                              jax_settings(st, intersector='brute'),
                              to_port(sj), cam, st)
    return out


def _adjoint(st, seed):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(st.height, st.width, 3)).astype(np.float32)


def test_project_and_screen_ray_match_jax(cases):
    _, cj, stj, _, cam, st = cases['triangle_sphere']
    W, H = st.width, st.height
    rs = np.random.default_rng(2)
    X = rs.uniform(-3, 3, (256, 3)).astype(np.float32)
    sj, dj = jax.vmap(lambda x: je._project(cj, W, H, x))(jnp.asarray(X))
    s, d = te._project(cam, W, H, torch.from_numpy(X))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-6)
    Jj = jax.vmap(jax.jacfwd(lambda x: je._project(cj, W, H, x)[0]))(
        jnp.asarray(X))
    J = te._project_jacobian(cam, W, H, torch.from_numpy(X))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(Jj).max()))
    spts = rs.uniform(-2, 26, (256, 2)).astype(np.float32)
    oj, dj = jax.vmap(lambda p: je._screen_ray(cj, W, H, p))(
        jnp.asarray(spts))
    o, d = te._screen_ray(cam, W, H, torch.from_numpy(spts))
    np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    # the screen ray through a projected point passes through the point
    back = te._project(cam, W, H, o + d * 5.0)[0]
    np.testing.assert_allclose(back.numpy(), spts, rtol=0, atol=1e-3)


def test_edge_cdf_sampling_rule():
    """The sampling rule on the weights of the main path's scene
    (sponza_standin's 280,942 edges seen at 1080p): both packages take the
    first edge whose CDF value is >= u, so every sample that picks another
    edge than the JAX package lies within the two CDFs' difference of a
    step of the port's CDF, and picks the next edge of nonzero weight
    before or after it (or a zero-weight edge next to it: jnp.cumsum
    associates its float32 partial sums in a tree, so its CDF can step at
    a zero weight). The port picks edges of nonzero weight only. (The
    share of such samples is 0.17-0.33% here, ROADMAP queue 3.)"""
    scene, cam, st = cpu(registry.sponza_standin)
    w = te._primary_edges(scene, cam, st.width, st.height)[3]
    n = 16_384
    k_e, k_s, _ = jax.random.split(jax.random.PRNGKey(KEY), 3)
    wj = jnp.asarray(w.numpy())
    cdf_j = np.asarray(jnp.cumsum(wj) / jnp.maximum(jnp.sum(wj), 1e-20))
    ue = np.asarray(jax.random.uniform(k_e, (n,)))
    es_j = np.clip(np.searchsorted(cdf_j, ue), 0, len(cdf_j) - 1)
    kt = rng.split(rng.PRNGKey(KEY), 3)
    es, ss, total = te._sample_edges(w, kt[0], kt[1], n)
    es = es.numpy()
    run = np.cumsum(w.numpy(), dtype=np.float64)
    cdf = (run / run[-1]).astype(np.float32)
    np.testing.assert_array_equal(es, np.searchsorted(cdf, ue))
    gap = float(np.abs(cdf_j.astype(np.float64) - cdf).max())
    assert gap < 1e-6, gap
    off = np.flatnonzero(es != es_j)
    assert len(off) < 0.005 * n, len(off)
    step = cdf[np.minimum(es[off], es_j[off])]
    assert (np.abs(ue[off] - step) <= gap).all()
    nz = np.flatnonzero(w.numpy() > 0)
    rank = np.searchsorted(nz, es[off]) - np.searchsorted(nz, es_j[off])
    assert (np.abs(rank) <= 1).all()
    assert (w.numpy()[es] > 0).all()
    np.testing.assert_array_equal(
        ss.numpy(), np.asarray(jax.random.uniform(k_s, (n,))))
    np.testing.assert_allclose(float(total), run[-1], rtol=1e-7)


@pytest.mark.parametrize('name', ['tri', 'inst_tri', 'triangle_sphere'])
def test_primary_edge_grad_matches_jax(cases, name):
    sj, cj, stj, sp, cam, st = cases[name]
    adj = _adjoint(st, 5)
    gj = je.edge_sampling_vertex_grad(sj, cj, stj, jnp.asarray(adj),
                                      jax.random.PRNGKey(KEY),
                                      n_samples=2048)
    g = te.edge_sampling_vertex_grad(sp, cam, st, torch.from_numpy(adj),
                                     rng.PRNGKey(KEY), n_samples=2048)
    assert float(g.abs().max()) > 0
    _close(g.numpy(), gj, name)


def test_shadow_edge_grad_matches_jax(cases):
    """On the JAX package's blocker fixture. (On triangle_sphere the
    light, the sphere's open seam and so the sampled points lie in the
    plane x = z, and a few shadow rays cross a mesh edge exactly, where
    the two tracers' float32 rounding decides the hit: ROADMAP queue 3.)"""
    name = 'blocker'
    sj, cj, stj, sp, cam, st = cases[name]
    adj = _adjoint(st, 6)
    gj = je.shadow_edge_vertex_grad(sj, cj, stj, jnp.asarray(adj),
                                    jax.random.PRNGKey(KEY), n_samples=2048)
    g = te.shadow_edge_vertex_grad(sp, cam, st, torch.from_numpy(adj),
                                   rng.PRNGKey(KEY), n_samples=2048)
    assert float(g.abs().max()) > 0
    _close(g.numpy(), gj, name)


def test_gi_edge_grad_matches_jax(cases):
    sj, cj, stj, sp, cam, st = cases['gi_blocker']
    adj = _adjoint(st, 7)
    gj = je.gi_edge_vertex_grad(sj, cj, stj, jnp.asarray(adj),
                                jax.random.PRNGKey(KEY), n_samples=8192)
    g = te.gi_edge_vertex_grad(sp, cam, st, torch.from_numpy(adj),
                               rng.PRNGKey(KEY), n_samples=8192)
    # the blocker (the last three vertices) gets a GI boundary term
    assert float(g[-3:].abs().max()) > 0
    _close(g.numpy(), gj, 'gi')


def test_radiance_restart_matches_jax(cases):
    """Rays restarted on the floor of the GI fixture as GI rays of the
    floor's material, half with the emitter's material as prev_mat."""
    sj, _, stj, sp, _, st = cases['gi_blocker']
    rs = np.random.default_rng(8)
    R = 512
    P = np.stack([rs.uniform(-2, 2, R), np.full(R, 1e-3),
                  rs.uniform(-2, 2, R)], -1).astype(np.float32)
    d = rs.normal(size=(R, 3))
    d[:, 1] = np.abs(d[:, 1]) + 0.3
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mat = np.where(np.arange(R) % 2 == 0, 0, 1).astype(np.int32)
    t0 = np.zeros(R, np.float32)
    want = jint.radiance(sj, stj, jnp.asarray(P), jnp.asarray(d),
                         jnp.asarray(t0), jax.random.PRNGKey(KEY),
                         kind0=jint.KIND_GI, prev_mat0=jnp.asarray(mat),
                         gi_bounces0=1)
    got = tint.radiance(sp, st, torch.from_numpy(P), torch.from_numpy(d),
                        torch.from_numpy(t0), rng.PRNGKey(KEY),
                        kind0=tint.KIND_GI, prev_mat0=torch.from_numpy(mat),
                        gi_bounces0=1)
    assert float(got.max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_loss_and_grads_with_edges_match_jax(cases):
    """On the GI fixture (the shadow term joins the same sum by the same
    code, and test_shadow_edge_grad_matches_jax holds it)."""
    name, kw, extra = 'gi_blocker', dict(shadow_edges=False,
                                         gi_edges=True), 'gi'
    sj, cj, stj, sp, cam, st = cases[name]
    rs = np.random.default_rng(9)
    target = rs.uniform(0, 0.5, (st.height, st.width, 3)).astype(np.float32)
    pj = js.get_params(sj)
    lj, gj = je.loss_and_grads_with_edges(
        pj, sj, cj, stj, jnp.asarray(target), jax.random.PRNGKey(KEY),
        edge_samples=2048, **kw)
    params = ts.get_params(sp)
    lt, gt = te.loss_and_grads_with_edges(
        params, sp, cam, st, torch.from_numpy(target), rng.PRNGKey(KEY),
        edge_samples=2048, **kw)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in ts.PARAM_KEYS:
        _close(gt[k].numpy(), gj[k], k)
    # the boundary terms reach the off-frame blocker (the last 3 vertices)
    terms = te.boundary_grads(params, sp, cam, st, torch.from_numpy(target),
                              rng.PRNGKey(KEY), edge_samples=2048, **kw)
    assert set(terms) == {'primary', extra}
    assert float(terms[extra][-3:].abs().max()) > 0


def test_train_step_with_edges():
    """One Adam step on the combined gradient moves the vertices as
    make_optimizer's Adam does on loss_and_grads_with_edges' gradients."""
    sj, cj, stj = fx._tri_scene()
    sp, cam, st = to_port(sj), port_camera(cj), port_settings(stj)
    target = torch.zeros(st.height, st.width, 3)
    key = rng.PRNGKey(KEY)
    ref = ts.get_params(sp)
    opt = ts.make_optimizer(ref, lr=1e-2)
    _, grads = te.loss_and_grads_with_edges(ref, sp, cam, st, target, key)
    for k in ts.PARAM_KEYS:
        ref[k].grad = grads[k]
    opt.step()
    params = ts.get_params(sp)
    opt2 = ts.make_optimizer(params, lr=1e-2)
    params, loss = te.train_step_with_edges(params, opt2, sp, cam, st,
                                            target, key)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    for k in ts.PARAM_KEYS:
        np.testing.assert_array_equal(params[k].numpy(), ref[k].numpy())
    assert not torch.equal(params['vertices'], sp.geom.vertices)
