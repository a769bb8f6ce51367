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
from raytracer_tpu_torch.parallel import sharding as ts
from raytracer_tpu_torch.render import integrator
from raytracer_tpu_torch.shading import textures

from .test_torch_train import KEY, _case
from .torch_port_util import jax_camera, jax_settings, to_port

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
                lambda t: vm.take(t, idx, 'corners_refine'), (x,))
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
