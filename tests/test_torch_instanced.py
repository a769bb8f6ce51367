"""Two-level instancing in the port against the JAX package, on the CPU.

* The port's own build (`SceneBuilder` without a BVH) gives instance and
  two-level cluster tables byte-equal to the JAX build's.
* The plain segment and hierarchical instance tracers agree with
  `pallas_iseg_trace` and `pallas_icluster_trace` (interpret mode, their
  default off-TPU) on hit or miss and on the any-hit flag for every ray,
  on t within rtol 1e-5 (with atol 1e-5: XLA may fuse the multiply-adds
  of the world -> object transform, and one ulp of an origin tens of units
  out moves a hit a few centimetres away by a few 1e-6), and on tri and
  inst except where t is exactly
  equal (the Pallas hierarchical kernel visits a block's instances in
  block-nearest order, so on an exact tie it may keep another instance's
  hit). The segment tracer is also held to the Pallas kernel's slice merge.
  The barycentrics a, b are recomputed from the winning triangle in the
  instance's object space on each side; XLA's einsum transform may round
  otherwise than the port's fixed-order sums, and at grazing triangles
  the MT numerators cancel, so they are held to atol 1e-4.
* The bundle cull, the CUDA wrapper's group boxes, `hit_attributes` and
  `refine_hit` on instance hits, and the intersector routing.
The CUDA kernels are held to these plain versions in tests/test_torch_cuda.py,
on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import intersect as jisect
from raytracer_tpu.ops.pallas import bundle as jbundle
from raytracer_tpu.ops.pallas import icluster_kernel as jick
from raytracer_tpu.ops.pallas import iseg_kernel as jisk
from raytracer_tpu.render import integrator as jint
from raytracer_tpu_torch.core.types import RenderSettings
from raytracer_tpu_torch.geometry.clusters import build_clusters as cl_build
from raytracer_tpu_torch.ops import cluster_trace as tct
from raytracer_tpu_torch.ops import bundle
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.render import integrator as tint
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, to_port

R = 256
# shallow prototypes take the segment tracer, deep ones the hierarchical one
SCENES = {
    'teapots': (registry.instanced_teapots_standin, {}),
    'forest': (registry.forest_standin, dict(n_trees=12, canopy=(30, 32))),
}
TRACERS = {'teapots': (jisk.pallas_iseg_trace, ist.iseg_trace),
           'forest': (jick.pallas_icluster_trace, ict.icluster_trace)}


def _both(name, **kw):
    make, base = SCENES.get(name, (None, {}))
    make = make or getattr(registry, name)
    sj, cam, st = cpu(make, 32, 24, builder=rj.SceneBuilder(), bvh=True,
                       **{**base, **kw})
    return sj, to_port(sj), cam, st


@pytest.fixture(scope='module', params=sorted(SCENES))
def scenes(request):
    return (request.param,) + _both(request.param)


def _rays(scene, cam, kind, seed=5):
    """Camera rays (16 x 16) or random rays from the lowest 2.5 m of the
    box between the 5th percentile of the instance boxes' lows and the
    95th of their highs (which leaves a large floor out) -> numpy (o, d)."""
    if kind == 'camera':
        o, d, _ = tcam.center_rays(cam, 16, R // 16)
        return o.numpy(), d.numpy()
    rs = np.random.default_rng(seed)
    ibb = scene.iclusters.ibb.numpy()
    real = ibb[0] < 1e37
    lo = np.percentile(ibb[:3, real], 5, axis=1).astype(np.float32)
    hi = np.percentile(ibb[3:, real], 95, axis=1).astype(np.float32)
    hi[1] = min(hi[1], lo[1] + 2.5)
    o = lo + rs.uniform(size=(R, 3)) * (hi - lo)
    d = rs.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _tmax(plain, sp, o, d, any_hit, seed=6):
    """Nearest rays reach far; any-hit rays stop at 0.5-1.5 times their
    nearest hit's distance. Every 7th ray is a dead lane (tmax < 0)."""
    tmax = np.full(R, 1e12, np.float32)
    if any_hit:
        near = plain(sp, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e-3,
                     torch.from_numpy(tmax), False).t.numpy()
        u = np.random.default_rng(seed).uniform(0.5, 1.5, R)
        tmax = np.minimum(near * u, 1e12).astype(np.float32)
    tmax[::7] = -1.0
    return tmax


def _assert_hits_agree(ht, hj, any_hit):
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    np.testing.assert_array_equal(tri_t >= 0, tri_j >= 0)   # hit or miss
    assert (tri_j >= 0).sum() > R // 10, 'too few hits to test anything'
    t_j = np.asarray(hj.t)
    np.testing.assert_allclose(ht.t.numpy(), t_j, rtol=1e-5, atol=1e-5)
    if any_hit:
        np.testing.assert_array_equal(tri_t, tri_j)          # the hit flag
        return
    differ = (tri_t != tri_j) | (ht.inst.numpy() != np.asarray(hj.inst))
    # another triangle or instance only at an exact tie in t
    np.testing.assert_array_equal(ht.t.numpy()[differ], t_j[differ])
    assert differ.mean() < 0.01
    same = ~differ
    np.testing.assert_allclose(ht.a.numpy()[same], np.asarray(hj.a)[same],
                               atol=1e-4)
    np.testing.assert_allclose(ht.b.numpy()[same], np.asarray(hj.b)[same],
                               atol=1e-4)


@pytest.mark.parametrize('name', ['teapots', 'forest'])
def test_build_tables_byte_equal(name):
    """The port's own build against the JAX build of the same calls."""
    sj, _, _, _ = _both(name)
    make, kw = SCENES[name]
    sp, _, _ = cpu(make, 32, 24, **kw)
    assert not sp.single_level
    icl = sp.iclusters
    for f in dataclasses.fields(icl):
        got, want = getattr(icl, f.name), getattr(sj.iclusters, f.name)
        if isinstance(got, torch.Tensor):
            got, want = got.numpy(), np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, f.name
            assert got.tobytes() == want.tobytes(), f.name
        else:
            assert got == want, f.name
    for f in ('m', 'm_inv', 'm_inv_t', 'tri_lo', 'tri_hi'):
        got, want = getattr(sp.instances, f).numpy(), \
            np.asarray(getattr(sj.instances, f))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    deep = icl.max_proto_clusters > 16
    assert deep == (name == 'forest')


@pytest.mark.parametrize('kind', ['random', 'camera'])
@pytest.mark.parametrize('any_hit', [False, True])
def test_plain_matches_pallas(scenes, kind, any_hit):
    name, sj, sp, cam, _ = scenes
    jtrace, plain = TRACERS[name]
    o, d = _rays(sp, cam, kind)
    tmax = _tmax(plain, sp, o, d, any_hit)
    hj = jtrace(sj, jnp.asarray(o), jnp.asarray(d), 0.0, 1e-3,
                jnp.asarray(tmax), any_hit, rb=32)
    ht = plain(sp, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e-3,
               torch.from_numpy(tmax), any_hit)
    _assert_hits_agree(ht, hj, any_hit)
    assert (ht.tri.numpy()[::7] == -1).all()


@pytest.mark.parametrize('any_hit', [False, True])
def test_segment_tracer_matches_pallas_slices(any_hit):
    """600 instances give 1,200 segments; at rb=1024 the Pallas wrapper
    cuts the table into 1,024-entry slices and merges their hits by
    nearest t, the later slice winning only on a strictly smaller t."""
    sj, sp, cam, _ = _both('instanced_grid_standin', n=600)
    assert sp.iclusters.num_entries > 1024
    o, d = _rays(sp, cam, 'camera')
    o2, d2 = _rays(sp, cam, 'random')
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    tmax = np.concatenate([_tmax(ist.iseg_trace, sp, o[:R], d[:R], any_hit),
                           _tmax(ist.iseg_trace, sp, o[R:], d[R:], any_hit)])
    hj = jisk.pallas_iseg_trace(sj, jnp.asarray(o), jnp.asarray(d), 0.0, 1e-3,
                                jnp.asarray(tmax), any_hit, rb=1024)
    ht = ist.iseg_trace(sp, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                        1e-3, torch.from_numpy(tmax), any_hit)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_array_equal(ht.inst.numpy(), np.asarray(hj.inst))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(hj.tri) >= 0).sum() > R // 10


def test_bundle_cull_matches_jax(scenes):
    """The same ray blocks give the same enabled flags, and no disabled
    block holds a ray that passes the box's slab test."""
    _, sj, sp, cam, _ = scenes
    o, d = _rays(sp, cam, 'camera')
    tmax = np.full(R, 1e12, np.float32)
    tmax[::3] = -1.0
    tmax[64:96] = -1.0                   # a block with no live ray
    tmin = np.full(R, 1e-3, np.float32)
    rays = bundle.ray_blocks(*(torch.from_numpy(x) for x in (o, d, tmin,
                                                              tmax)), 32)
    bb = sp.iclusters.ibb
    lo, hi = bundle.box_union(bb)
    jlo, jhi = jbundle.box_union(jnp.asarray(bb.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    small = (lo + (hi - lo) * 0.45, lo + (hi - lo) * 0.55)
    behind = (torch.from_numpy(o[0]) - 10 * torch.from_numpy(d[0]) - 0.1,
              torch.from_numpy(o[0]) - 10 * torch.from_numpy(d[0]) + 0.1)
    flags = []
    for box in ((lo, hi), small, behind):
        en = bundle.make_block_culler(rays)(*box)
        jen = jbundle.make_block_culler(jnp.asarray(rays.numpy()))(
            *(jnp.asarray(x.numpy()) for x in box))
        np.testing.assert_array_equal(en.numpy(), np.asarray(jen))
        keys = ist.slab_keys(box[0][None, None], box[1][None, None],
                             torch.from_numpy(o), ist.rcp(torch.from_numpy(d)),
                             torch.from_numpy(tmin), torch.from_numpy(tmax))
        reach = (keys[:, 0] < torch.from_numpy(tmax)).reshape(-1, 32).any(1)
        assert not (reach & ~en).any()
        off = bundle.disable_blocks(rays, en)
        assert (off[~en, 7] == -1).all() and (off[en] == rays[en]).all()
        flags.append(en)
    flags = torch.stack(flags)
    assert flags[0].sum() == 7 and not flags[2].any()


def test_hit_attributes_and_refine_hit_on_instance_hits(scenes):
    """Shading attributes (normals through m_inv_t) and the object-space
    refine on the plain tracer's instance hits, against the JAX package's
    on the same hits; vertex gradients of the refined t as well."""
    _, sj, sp, cam, _ = scenes
    o, d = _rays(sp, cam, 'camera')
    tracer = tint.trace_fn(sp, RenderSettings())
    h = tracer(torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e-3, 1e12,
               False)
    assert (h.inst[h.valid] > 0).any()
    tri = h.tri.clamp(min=0)
    got = tint.hit_attributes(sp, tri, h.inst, h.a, h.b)
    want = jint.hit_attributes(sj, jnp.asarray(tri.numpy()),
                               jnp.asarray(h.inst.numpy()),
                               jnp.asarray(h.a.numpy()),
                               jnp.asarray(h.b.numpy()))
    v = h.valid.numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], atol=2e-5)

    jh = jisect.Hit(t=jnp.asarray(h.t.numpy()), tri=jnp.asarray(h.tri.numpy()),
                    inst=jnp.asarray(h.inst.numpy()),
                    a=jnp.asarray(h.a.numpy()), b=jnp.asarray(h.b.numpy()))

    def jt(verts):
        s = sj.replace(geom=sj.geom.replace(vertices=verts))
        t, a, b = jisect.refine_hit(s, jnp.asarray(o), jnp.asarray(d), 0.0,
                                    jh)
        return (t + a + b).sum(), (t, a, b)
    (_, want), jgrad = jax.value_and_grad(jt, has_aux=True)(sj.geom.vertices)
    verts = sp.geom.vertices.clone().requires_grad_(True)
    s2 = dataclasses.replace(sp, geom=dataclasses.replace(sp.geom,
                                                         vertices=verts))
    got = tisect.refine_hit(s2, torch.from_numpy(o), torch.from_numpy(d),
                            0.0, h)
    sum(x.sum() for x in got).backward()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    np.testing.assert_allclose(verts.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-3, atol=1e-3)
    assert np.abs(verts.grad.numpy()).sum() > 0


def test_routing_and_unported_modes(scenes):
    """'auto' and 'cluster2' take the segment tracer for shallow
    prototypes and the hierarchical one for deep ones, and trace a
    motion-blurred world partition with the cluster tracer in `mb` mode;
    'brute' raises."""
    name, _, sp, cam, _ = scenes
    plain = TRACERS[name][1]
    mod = ist if plain is ist.iseg_trace else ict
    o, d = _rays(sp, cam, 'camera')
    for mode in ('auto', 'cluster2'):
        calls = mod.CALLS
        tint.trace_fn(sp, RenderSettings(intersector=mode))(
            torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e-3, 1e12, False)
        assert mod.CALLS == calls + 1
    with pytest.raises(NotImplementedError):
        tint.trace_fn(sp, RenderSettings(intersector='brute'))
    # the world prototype's triangles once more, as a (static) partition:
    # its hits tie with the instance tracer's, which keeps them
    icl = sp.iclusters
    world = icl.tri[:int(icl.pmeta[0, 1])].reshape(-1)
    mb = dataclasses.replace(
        sp, has_motion_blur=True,
        mb_clusters=cl_build(sp.geom, tri_ids=world[world >= 0].numpy()))
    calls, mb_calls = mod.CALLS, tct.CALLS
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.5, 1e-3, 1e12,
            False)
    h = tint.trace_fn(mb, RenderSettings())(*args)
    assert mod.CALLS == calls + 1 and tct.CALLS == mb_calls + 1
    want = plain(sp, *args)
    for f in ('t', 'tri', 'inst'):
        np.testing.assert_array_equal(getattr(h, f).numpy(),
                                      getattr(want, f).numpy())
