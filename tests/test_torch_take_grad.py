"""The backward of the port's gathers, on the CPU: core/vecmath.take (an
autograd Function whose backward is scatter_rows) and vecmath.permute (the
wavefront sort's, whose backward gathers by the inverse permutation).

* take's gradient against autograd of index_select (today's backward,
  zeros.index_add_) bit for bit: row tables and scalar tables, (R, K)
  indices as the triangle corners' and the texel pool's, int32 and int64,
  every row hit by one index, unhit rows, and no index at all.
* permute's gradient against index_add_ over the permutation: equal in
  value (a -0.0 cotangent stays -0.0 in the gather, where index_add's
  zeros + -0.0 give +0.0; torch.equal holds them equal).
* A float64 gradcheck of both, and their profiler ranges by call site
  (vecmath.PROFILE_SITES).
* Adding nothing for an exactly zero contribution, as the take-scatter
  kernel does, leaves index_add_'s result bit for bit (an entry begins at
  +0.0, and a sum begun at +0.0 never becomes -0.0).
* scripts/take_stats.stats, the counts the profile and phase 42 print,
  against counts by hand; its watched_takes keeps each take gradient
  that reaches scatter_rows (of the tables asked for) and puts
  scatter_rows back.
* The bounce step gathers the triangle corners once a bounce, for
  refine_hit and hit_attributes both, and given those corners the two
  return what they return without them, bit for bit (single-level,
  instanced and motion-blurred scenes).
* The scanned step (`sharding.loss_and_grads_scanned`) to all six leaves
  bit for bit against the same step with take and permute put back to
  plain index_select (autograd's backward of the parent tree), on the
  12-sphere `sponza_standin` at 32x24 with 3 bounces, and with remat on,
  and on tests/test_torch_train.py's 4x4-texel quad (the `tex_data`
  leaf); the atrium also against the JAX package's step under
  test_loss_and_grads_match_jax's tolerances (loss rtol 1e-5, each leaf
  rtol 1e-3 and atol 1e-4 x max|leaf|), as that test holds the quad.

On the card the backward is the take-scatter kernel
(csrc/grad/take_scatter.cu), held to index_add_ in tests/test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.parallel import sharding as js
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import integrator
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.shading import textures
from scripts.take_stats import stats, watched_takes

from .test_torch_train import KEY, _case
from .torch_port_util import jax_camera, jax_settings, scene_rays, to_port

# (table shape, index shape, index dtype, rows the index may name)
TAKES = dict(
    rows=((7, 3), (50,), torch.int64, 5),            # rows 5, 6 unhit
    corners=((11, 3), (40, 3), torch.int32, 11),
    scalars=((6,), (30,), torch.int64, 6),
    texels=((100,), (20, 16), torch.int64, 100),
    matrices=((5, 2, 3), (9, 2), torch.int32, 5),
    once=((9, 2), (9,), torch.int64, 9),             # a permutation
    empty=((4, 3), (0,), torch.int64, 4),
    empty_corners=((4, 3), (0, 3), torch.int32, 4))


def _index(name, seed=0):
    shape, ishape, dtype, rows = TAKES[name]
    rs = np.random.default_rng(seed)
    if name == 'once':
        idx = rs.permutation(rows)
    else:
        # sorted runs with repeats, as a Morton-sorted wavefront's
        idx = np.sort(rs.integers(0, rows, ishape), axis=0)
    return shape, torch.from_numpy(np.asarray(idx).reshape(ishape)).to(dtype)


def _old_take(x, idx, site='take'):
    """take as it was: index_select, with autograd's own backward."""
    out = torch.index_select(x, 0, idx.reshape(-1).long())
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def _grad(fn, x, *args, seed=1):
    x = x.clone().requires_grad_(True)
    y = fn(x, *args)
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(y.shape)).astype(np.float32)).to(x.dtype)
    (y * w).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize('name', sorted(TAKES))
def test_take_grad_equals_index_select_grad(name):
    shape, idx = _index(name)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=shape).astype(np.float32))
    y, g = _grad(lambda t, i: vm.take(t, i, 'kd'), x, idx)
    y0, g0 = _grad(_old_take, x, idx)
    assert y.shape == tuple(idx.shape) + shape[1:]
    assert torch.equal(y.view(torch.int32), y0.view(torch.int32))
    assert torch.equal(g.view(torch.int32), g0.view(torch.int32))
    assert g.shape == x.shape
    # integer tables keep no graph
    assert not vm.take(idx, idx.long().clamp(max=0)).requires_grad


@pytest.mark.parametrize('R', [0, 1, 257])
def test_permute_grad_equals_index_add(R):
    rs = np.random.default_rng(R)
    perm = torch.from_numpy(rs.permutation(R)).long()
    inv = torch.empty_like(perm).scatter_(0, perm, torch.arange(R))
    for shape in ((R, 3), (R,), (R, 12)):
        x = torch.from_numpy(rs.normal(size=shape).astype(np.float32))
        y, g = _grad(lambda t: vm.permute(t, perm, inv), x)
        _, g_old = _grad(_old_take, x, perm)
        w = torch.from_numpy(np.random.default_rng(1).normal(
            size=shape).astype(np.float32))
        want = torch.zeros(shape).index_add_(0, perm, w)
        assert torch.equal(y, x[perm])
        assert torch.equal(g, want) and torch.equal(g, g_old)
    # no gradient wanted: no inverse needed, no graph
    assert torch.equal(vm.permute(x, perm, None), x[perm])
    with pytest.raises(ValueError, match='inv'):
        vm.permute(x.requires_grad_(True), perm, None)


@pytest.mark.parametrize('sites', [False, True])
def test_site_ranges_only_under_the_switch(sites, monkeypatch):
    """vecmath.PROFILE_SITES opens a profiler range named by the call site
    around each take and permute backward; off, there is none (the
    benchmark's profile sums every device event, ranges' too)."""
    monkeypatch.setattr(vm, 'PROFILE_SITES', sites)
    _, idx = _index('rows')
    x = torch.ones((7, 3), requires_grad=True)
    perm = torch.arange(50)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y = vm.permute(vm.take(x, idx, 'kd'), perm, perm)
        y.sum().backward()
    names = {e.name for e in prof.events()}
    assert ({'kd', 'sort'} <= names) == sites
    assert not ({'kd', 'sort'} & names) or sites


@pytest.mark.parametrize('fn', ['take', 'permute'])
def test_gradcheck(fn):
    rs = np.random.default_rng(5)
    if fn == 'take':
        for name in ('rows', 'corners', 'texels', 'matrices'):
            shape, idx = _index(name)
            x = torch.from_numpy(rs.normal(size=shape)).requires_grad_(True)
            assert torch.autograd.gradcheck(
                lambda t: vm.take(t, idx, 'corners'), (x,))
    else:
        perm = torch.from_numpy(rs.permutation(13)).long()
        inv = torch.argsort(perm)
        x = torch.from_numpy(rs.normal(size=(13, 3))).requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda t: vm.permute(t, perm, inv), (x,))


def _port_step(sp, cam, st, params, target, tile):
    return ts.loss_and_grads_scanned(
        {k: v.clone() for k, v in params.items()}, sp, cam, st,
        torch.from_numpy(target), rng.PRNGKey(KEY), spp=1, tile=tile)


@pytest.mark.parametrize('name', ['sponza_12', 'textured_quad'])
def test_step_grads_as_before_and_as_jax(name, monkeypatch):
    sj, cam, st, tile, jmode = _case(name)
    sp = to_port(sj)
    pj = {k: np.asarray(v) for k, v in js.get_params(sj).items()}
    target = np.random.default_rng(4).uniform(
        0, 0.5, (st.height, st.width, 3)).astype(np.float32)
    if name == 'sponza_12':
        target[:] = 0.0
        assert (st.width, st.height, st.max_bounces) == (32, 24, 3)
    else:
        pj['kd'] = (pj['kd'] * 0.9).astype(np.float32)
    params = convert.params_from_arrays(pj, device='cpu')
    loss, grads = _port_step(sp, cam, st, params, target, tile)
    runs = {}
    if name == 'sponza_12':
        runs['remat'] = _port_step(sp, cam, dataclasses.replace(
            st, remat=True), params, target, tile)
    with monkeypatch.context() as m:
        for mod, attr in ((vm, 'take'), (integrator, '_take'),
                          (textures, 'take')):
            m.setattr(mod, attr, _old_take)
        m.setattr(vm, 'permute', lambda x, perm, inv: _old_take(x, perm))
        runs['index_select'] = _port_step(sp, cam, st, params, target, tile)
    for tag, (loss_b, grads_b) in runs.items():
        assert torch.equal(loss_b, loss), tag
        for k in ts.PARAM_KEYS:
            assert torch.equal(grads_b[k], grads[k]), (tag, k)
    leaf = 'tex_data' if name == 'textured_quad' else 'kd'
    assert float(grads['vertices'].abs().max()) > 0
    assert float(grads[leaf].abs().max()) > 0
    if name != 'sponza_12':
        return      # test_torch_train holds the quad's step to JAX's
    lj, gj = js.loss_and_grads_scanned(
        {k: jnp.asarray(v) for k, v in pj.items()}, sj, jax_camera(cam),
        jax_settings(st, intersector=jmode), jnp.asarray(target),
        jax.random.PRNGKey(KEY), spp=1, tile=tile)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    for k in ts.PARAM_KEYS:
        got, want = grads[k].numpy(), np.asarray(gj[k])
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize('case', ['hot_row', 'runs', 'random'])
def test_dropping_exact_zeros_leaves_index_add(case):
    """index_add_ into zeros of a gradient with +0.0 and -0.0 rows and
    channels mixed in equals, bit for bit, index_add_ of its rows that are
    not all zero, and of its elements that are not zero: what the
    take-scatter kernel skips adds nothing. A row only zeros reach is
    +0.0; a NaN still reaches its row."""
    rs = np.random.default_rng(7)
    M, N, C = 50, 4000, 3
    if case == 'hot_row':
        idx = np.sort(rs.integers(1, M, N))
    elif case == 'runs':
        idx = np.repeat(rs.integers(0, M, N // 8), 8)
    else:
        idx = rs.integers(0, M, N)
    g = rs.normal(size=(N, C)).astype(np.float32)
    zero = rs.uniform(size=N) < 0.3
    if case == 'hot_row':
        idx[zero] = 0
    g[zero] = 0.0
    g[rs.uniform(size=(N, C)) < 0.1] = 0.0
    g = np.where(rs.uniform(size=(N, C)) < 0.5, g, -g)    # -0.0 among them
    assert (np.signbit(g) & (g == 0)).any()
    if case == 'random':
        g[17, 1] = np.nan
    idx, g = torch.from_numpy(idx), torch.from_numpy(g)
    full = torch.zeros((M, C)).index_add_(0, idx, g)
    keep = ~(g == 0).all(dim=-1)
    rows = torch.zeros((M, C)).index_add_(0, idx[keep], g[keep])
    flat_idx = (idx[:, None] * C + torch.arange(C)).reshape(-1)
    nz = g.reshape(-1) != 0
    elems = torch.zeros(M * C).index_add_(
        0, flat_idx[nz], g.reshape(-1)[nz]).reshape(M, C)
    assert torch.equal(_bits(rows), _bits(full))
    assert torch.equal(_bits(elems), _bits(full))
    if case == 'hot_row':
        assert torch.equal(_bits(full[0]), torch.zeros(C, dtype=torch.int32))
    if case == 'random':
        assert bool(torch.isnan(full[idx[17], 1]))


def test_step_gathers_the_corners_once_a_bounce(monkeypatch):
    """The bounce step takes the triangle corners once a bounce (site
    `corners`) and hands them to refine_hit and hit_attributes, so a
    3-bounce step on the 12-sphere atrium makes 3 corner takes with a
    backward in its forward pass, where two gathers a bounce made 6 (the
    tracers' own gathers, under no_grad, have none)."""
    scene, cam, st = registry.sponza_standin(32, 24, max_bounces=3,
                                             n_spheres=12, device='cpu')
    sites, steps = [], [0]
    take, step = vm.take, integrator._step

    def counted_take(x, idx, site='take'):
        if x.requires_grad and torch.is_grad_enabled():   # a backward's
            sites.append(site)
        return take(x, idx, site)

    def counted_step(*args, **kw):
        steps[0] += 1
        return step(*args, **kw)
    monkeypatch.setattr(vm, 'take', counted_take)
    monkeypatch.setattr(integrator, '_step', counted_step)
    target = torch.zeros((st.height, st.width, 3))
    loss, grads = ts.loss_and_grads_scanned(ts.get_params(scene), scene, cam,
                                            st, target, rng.PRNGKey(KEY))
    assert steps[0] == st.max_bounces == 3
    assert sites.count('corners') == 3
    assert not {'corners_refine', 'corners_geoN'} & set(sites)
    assert float(grads['vertices'].abs().max()) > 0


def _shared_corner_scene(name):
    if name == 'single':
        return registry.sponza_standin(32, 24, max_bounces=1, n_spheres=12,
                                       device='cpu')
    if name == 'instanced':
        return registry.instanced_teapots_standin(32, 24, device='cpu')
    return registry.mb_bullet_standin(16, device='cpu')


@pytest.mark.parametrize('name', ['single', 'instanced', 'motion_blur'])
def test_refine_and_attributes_given_the_corners(name):
    """refine_hit and hit_attributes given the bounce step's corners
    (isect.tri_corners of the clamped ids) return what they return
    without them, bit for bit, and so does each one's vertex gradient;
    the two together differ in the vertex gradient by float rounding
    only (one index_add_ of the summed gradient, not two)."""
    scene, _, st = _shared_corner_scene(name)
    assert scene.has_motion_blur == (name == 'motion_blur')
    assert scene.single_level == (name != 'instanced')
    R = 512
    o, d, time, _ = (torch.from_numpy(x) for x in scene_rays(scene, R, 3))
    hit = integrator.trace_fn(scene, st)(o, d, time, 1e-3, 1e12, False)
    assert bool(hit.valid.any()) and not bool(hit.valid.all())
    tri = hit.tri.clamp(min=0)
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=(R, 17)).astype(np.float32))

    def run(shared, parts=('refine', 'attributes')):
        verts = scene.geom.vertices.clone().requires_grad_(True)
        s = dataclasses.replace(scene, geom=dataclasses.replace(
            scene.geom, vertices=verts))
        corners = isect.tri_corners(s, tri) if shared else None
        t, a, b = isect.refine_hit(s, o, d, time, hit, corners=corners)
        if 'refine' not in parts:
            t, a, b = t.detach(), a.detach(), b.detach()
        outs = [t, a, b]
        if 'attributes' in parts:
            outs += integrator.hit_attributes(s, tri, hit.inst, a, b,
                                              corners=corners)
        y = torch.cat([x.reshape(R, -1) for x in outs], dim=1)
        (y * w[:, :y.shape[1]]).sum().backward()
        return y.detach(), verts.grad
    for parts in (('refine',), ('attributes',)):
        y, g = run(True, parts)
        y0, g0 = run(False, parts)
        assert torch.equal(_bits(y), _bits(y0)), parts
        assert torch.equal(_bits(g), _bits(g0)), parts
        assert float(g.abs().max()) > 0, parts
    y, g = run(True)
    y0, g0 = run(False)
    assert y.shape == (R, 17)
    assert torch.equal(_bits(y), _bits(y0))
    np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-5,
                               atol=1e-6 * float(g0.abs().max()))


def test_take_kernel_stats_counts():
    """take_stats.stats on a hand-made launch: 64 rows of one column, a
    warp of runs of 4 then a warp of one row, the second warp's gradient
    zero but for one entry."""
    idx = torch.cat([torch.arange(32) // 4 + 10, torch.zeros(32)]).long()
    g = torch.zeros((64, 1, 3))
    g[:32] = 1.0
    g[40, 0, 1] = -0.0
    g[41, 0, 2] = 2.0
    st = stats(g, idx[:, None].int(), chunks=(16, 64))
    assert st == dict(entries=64, zero_entries=31, distinct_rows=9,
                      top_row=0, top_row_entries=32, top_row_zero_entries=31,
                      mean_run=64 / 9, run_adds=3 * 9,
                      chunk_rows={16: 8 + 1, 64: 9})
    empty = stats(torch.zeros((0, 3, 3)), torch.zeros((0, 3)).long())
    assert empty['entries'] == 0 and empty['distinct_rows'] == 0


@pytest.mark.parametrize('shapes', [None, {(7, 3)}])
def test_watched_takes_keeps_each_gradient(shapes):
    """Two takes, one into a (7, 3) and one into a (100,) table: the
    watch keeps each gradient and index (or only the asked table's) as
    scatter_rows received them, and the gradients are as without it."""
    _, idx = _index('rows')
    _, tix = _index('texels')
    rs = np.random.default_rng(5)
    x = torch.from_numpy(rs.normal(size=(7, 3)).astype(np.float32))
    t = torch.from_numpy(rs.normal(size=(100,)).astype(np.float32))

    def grads():
        xr, tr = x.clone().requires_grad_(True), t.clone().requires_grad_(True)
        loss = (vm.take(xr, idx, 'kd') ** 2).sum() \
            + (vm.take(tr, tix, 'tex') * 3.0).sum()
        loss.backward()
        return xr.grad, tr.grad
    scatter_rows = vm.scatter_rows
    want = grads()
    with watched_takes(shapes) as seen:
        got = grads()
    assert vm.scatter_rows is scatter_rows
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    by_shape = {shape: (g, i) for shape, g, i in seen}
    assert set(by_shape) == ({(7, 3), (100,)} if shapes is None
                             else {(7, 3)})
    g, i = by_shape[(7, 3)]
    assert torch.equal(i, idx)
    assert torch.equal(vm.scatter_rows(g, i, (7, 3)), want[0])
    if shapes is None:
        g, i = by_shape[(100,)]
        assert torch.equal(i, tix) and bool((g == 3.0).all())
