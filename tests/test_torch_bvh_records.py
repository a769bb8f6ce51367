"""The wide-BVH kernel's records and stack limit, on the CPU.

ops/cuda/bvh_kernel packs the scene's BVH into the records the kernel
reads, with plain torch operations: one 128-byte record a node and one
triangle record a prim_order slot. Unpacked, they must give back the
tables the plain walk reads, byte for byte, on the scenes that
tests/test_torch_bvh.py builds with the JAX package and carries across
(single level, two levels, motion blur, alpha maps, a motion-blurred
prototype): every node slot, the empty slots (count -1) and instance
slots (count <= -2) among them, and each triangle leaf's corners and
edges, the edges being the float32 subtractions the kernel made before.
The records are kept while their source tensors stay the same tensors at
the same version, and the kernel's stack limit refuses what it cannot
hold.
"""
import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu_torch.ops import traverse as ttr
from raytracer_tpu_torch.ops.cuda import bvh_kernel as bvk
from raytracer_tpu_torch.scenes import registry

from .test_torch_bvh import SCENES
from .torch_port_util import cpu, to_port

CARRIED = ('sponza_12', 'teapots', 'mb_bullet', 'alpha_leaf', 'mb_proto')


@pytest.fixture(scope='module', params=CARRIED)
def carried(request):
    """(the JAX build as numpy arrays, the same scene carried across)."""
    make, kw = SCENES[request.param]
    sj = cpu(make, builder=rj.SceneBuilder(), bvh=True, **kw)[0]
    return request.param, sj, to_port(sj)


def _np(x):
    return np.asarray(x)


def _bits(x):
    return _np(x).view(np.int32)


def test_node_records_unpack_to_the_tables(carried):
    name, sj, sp = carried
    rec = bvk.node_records(sp.blas).numpy()
    N, B = _np(sj.blas.child).shape
    assert rec.shape == (N, 32) and rec.dtype == np.float32
    assert rec.nbytes == 128 * N
    box = lambda cols: np.ascontiguousarray(
        rec[:, cols].reshape(N, 3, B).transpose(0, 2, 1))
    for got, f in ((box(slice(0, 12)), 'node_min'),
                   (box(slice(12, 24)), 'node_max'),
                   (_bits(rec[:, 24:28]), 'child'),
                   (_bits(rec[:, 28:32]), 'count')):
        want = _np(getattr(sj.blas, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    # the slots the walk leaves out or descends through as the plain
    # walk reads them
    count = _np(sj.blas.count)
    assert (_bits(rec[:, 28:32])[count == -1] == -1).all()
    assert (count == -1).any()
    if not sp.single_level:
        inst = count <= -2
        assert inst.any(), name
        got = _bits(rec[:, 24:28])[inst]
        np.testing.assert_array_equal(got, _np(sj.blas.child)[inst])


def _leaf_slots(sj):
    """The prim_order slots of the triangle leaves and of the instance
    leaves (count -(n + 1))."""
    child, count = _np(sj.blas.child), _np(sj.blas.count)
    tri = [np.arange(c, c + n) for c, n in zip(child[count > 0],
                                                count[count > 0])]
    inst = [np.arange(c, c - n - 1) for c, n in zip(child[count <= -2],
                                                    count[count <= -2])]
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)
    return cat(tri), cat(inst)


def test_tri_records_unpack_to_the_tables(carried):
    name, sj, sp = carried
    mb = sp.has_motion_blur
    g = sp.geom
    rec = bvk.tri_records(sp.blas.prim_order, g.face_v, g.vertices,
                          g.vertices_t1 if mb else None).numpy()
    P = _np(sj.blas.prim_order).shape[0]
    assert rec.shape == (P, 24 if mb else 12) and rec.dtype == np.float32
    tri_slots, inst_slots = _leaf_slots(sj)
    assert tri_slots.size > 0
    prim = _np(sj.blas.prim_order)
    tri = prim[tri_slots]
    fv = _np(sj.geom.face_v)[tri]
    v0 = _np(sj.geom.vertices)[fv]                       # (n, 3 corners, 3)
    r = rec[tri_slots]
    np.testing.assert_array_equal(_bits(r[:, 3]), tri)
    if mb:
        v1 = _np(sj.geom.vertices_t1)[fv]
        want = np.concatenate([v0, v1], 1)               # (n, 6, 3)
        got = r.reshape(-1, 6, 4)[:, :, :3]
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), name
    else:
        # p0, then the edges as the float32 subtractions p1 - p0, p2 - p0
        want = np.stack([v0[:, 0], v0[:, 1] - v0[:, 0], v0[:, 2] - v0[:, 0]],
                        1)
        got = r.reshape(-1, 3, 4)[:, :, :3]
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), name
    assert (r.reshape(len(r), -1, 4)[:, 1:, 3] == 0).all()
    if not sp.single_level:
        # instance slots: the kernel reads prim_order and inst_root there,
        # as the plain walk does, and no triangle record
        assert inst_slots.size > 0
        assert not np.isin(inst_slots, tri_slots).any()
        assert sp.blas.prim_order.numpy()[inst_slots].tobytes() \
            == prim[inst_slots].tobytes()


def test_records_are_kept_until_a_source_changes():
    """A second call returns the same records; an in-place update of the
    vertices rebuilds the triangle records (not the node records), and so
    does a new vertex tensor; the rebuilt records hold the new corners."""
    scene = cpu(registry.triangle_sphere, size=8, bvh=True)[0]
    nodes, tris = bvk.records(scene)
    again = bvk.records(scene)
    assert again[0] is nodes and again[1] is tris
    g = scene.geom
    g.vertices.add_(0.25)                 # a trainer's in-place step
    nodes2, tris2 = bvk.records(scene)
    assert nodes2 is nodes and tris2 is not tris
    assert torch.equal(tris2, bvk.tri_records(scene.blas.prim_order,
                                              g.face_v, g.vertices))
    assert not torch.equal(tris2, tris)
    assert bvk.records(scene)[1] is tris2
    moved = dataclasses.replace(scene, geom=dataclasses.replace(
        g, vertices=g.vertices * 2.0))
    tris3 = bvk.records(moved)[1]
    assert tris3 is not tris2
    assert torch.equal(tris3[:, :3], tris2[:, :3] * 2.0)
    # a new node tensor rebuilds the node records
    blas = dataclasses.replace(scene.blas,
                               node_min=scene.blas.node_min.clone())
    assert bvk.records(dataclasses.replace(scene, blas=blas))[0] \
        is not nodes


def test_mb_records_follow_the_t1_pose():
    """A motion-blurred scene's triangle records carry both poses and are
    rebuilt when vertices_t1 changes in place."""
    sp = cpu(registry.mb_bullet_standin, size=8, bvh=True)[0]
    assert sp.has_motion_blur
    tris = bvk.records(sp)[1]
    assert tris.shape[1] == 24
    sp.geom.vertices_t1.mul_(1.5)
    tris2 = bvk.records(sp)[1]
    assert tris2 is not tris
    assert torch.equal(tris2, bvk.tri_records(
        sp.blas.prim_order, sp.geom.face_v, sp.geom.vertices,
        sp.geom.vertices_t1))


def test_stack_limit_refuses_what_it_cannot_hold():
    """The kernel takes stack bounds up to bvk.STACK: a sponza-sized
    bound (71) runs with its first bvk.SHARED entries in shared memory; a
    deeper BVH raises before any launch, naming the limit."""
    sponza = cpu(registry.sponza_standin, 32, 24, bvh=True)[0]
    S, K = bvk.stack_split(sponza.blas)
    assert S == ttr.stack_bound(sponza.blas) == 71
    assert K == min(S, bvk.SHARED) and 1 <= K <= S
    B = sponza.blas.child.shape[1]
    fixed = ttr.stack_bound(dataclasses.replace(sponza.blas, depth=0))
    top = (bvk.STACK - fixed) // (B - 1)
    ok = dataclasses.replace(sponza.blas, depth=top)
    assert bvk.stack_split(ok) == (ttr.stack_bound(ok), bvk.SHARED)
    assert ttr.stack_bound(ok) <= bvk.STACK
    deep = dataclasses.replace(sponza.blas, depth=top + 1)
    assert ttr.stack_bound(deep) > bvk.STACK
    with pytest.raises(ValueError, match=f'at most {bvk.STACK}'):
        bvk.stack_split(deep)
    small = cpu(registry.triangle_sphere, size=8, bvh=True)[0]
    S, K = bvk.stack_split(small.blas)
    assert K == min(S, bvk.SHARED)
