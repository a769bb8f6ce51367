"""The group walk of the trace kernels, on the CPU: the group levels
(ops/bundle.group_levels) and the wrappers' cache of them, the plain
tracers' cull that repeats the kernels' walk, the box tests it saves, and
the kernel build's hash of the shared CUDA header.

A union box's key is never larger than a member's, so the walk drops only
what the flat scan drops: the plain tracers must return what a brute-force
sweep returns (t, a and b within rtol 1e-5: the sweep forms the edges and
sums the products in its own order) and exactly what their flat scan
returns, on rays that graze the group boxes' faces too.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import native
from raytracer_tpu_torch.geometry.clusters import NEVER
from raytracer_tpu_torch.ops import bundle
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import intersect as isect
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.ops.cuda import cluster_kernel as ck
from raytracer_tpu_torch.ops.cuda import icluster_kernel as ick
from raytracer_tpu_torch.ops.cuda import iseg_kernel as isk
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import (box_rays, cluster_table, cpu, grazing_rays,
                              instanced_table, segment_table, table_rays)

R = 256
# the reduced final forest of the CPU/GPU parity check (chip_smoke.py)
FOREST = dict(n_trees=4, n_flowers=20, grass_grid=8, max_bounces=1)


def _random_boxes(n, seed):
    """(6, n) random boxes in table order along a line; every 11th from
    the 6th on and, from 8 boxes on, the last 3 are padding (the never-hit
    point box)."""
    rs = np.random.default_rng(seed)
    lo = (np.arange(n)[:, None] * 0.3 + rs.uniform(-1, 1, (n, 3)))
    hi = lo + rs.uniform(0.01, 1.0, (n, 3))
    bb = np.concatenate([lo, hi], 1).T.astype(np.float32)
    bb[:, 5::11] = NEVER
    if n >= 8:
        bb[:, n - 3:] = NEVER
    return torch.from_numpy(np.ascontiguousarray(bb))


def _keys(bb, o, inv, tmin, tmax):
    return ct.slab_keys(bb[:3].T[None], bb[3:].T[None], o, inv, tmin, tmax)


@pytest.mark.parametrize('case', [1, 7, 8, 9, 63, 65, 513, 4097,
                                  'teapots', 'forest'])
def test_group_levels_are_conservative(case):
    """At every level, no real member box escapes its group, a group of
    padding lanes only is the never-hit box, and a group's key never
    exceeds its members' (so the kernels may skip it). The instanced
    scenes' segment tables take the segment kernel's 32-wide levels."""
    if isinstance(case, int):
        bb, fan, depth = _random_boxes(case, case), ct.GROUP, ct.DEPTH
    else:
        make, kw = ((registry.instanced_teapots_standin, {}) if
                    case == 'teapots' else
                    (registry.forest_standin, dict(n_trees=12)))
        scene, _, _ = cpu(make, 32, 24, **kw)
        bb, fan, depth = scene.iclusters.sbb, ist.SEG_GROUP, ist.SEG_DEPTH
    real = bb[0] < 1e37
    lo, hi = bb[:3, real].amin(1) - 1, bb[3:, real].amax(1) + 1
    o, d = (torch.from_numpy(x) for x in box_rays(lo, hi, R, 5))
    inv = ct.rcp(d)
    tmin, tmax = torch.full((R,), 1e-3), torch.full((R,), 1e12)
    levels = bundle.group_levels(bb, fan, depth)
    member = bb
    for group in levels:
        n = member.shape[1]
        assert group.shape == (6, -(-n // fan))
        pad = torch.nn.functional.pad(member, (0, (-n) % fan), value=NEVER)
        m = pad.reshape(6, -1, fan)
        real = m[0] < 1e37                                  # (groups, fan)
        g = group[:, :, None]
        assert ((m[:3] >= g[:3]) & (m[3:] <= g[3:])).all(0)[real].all()
        empty = ~real.any(1)
        assert (group[:, empty] == NEVER).all()
        kg = _keys(group, o, inv, tmin, tmax)
        km = torch.nn.functional.pad(_keys(member, o, inv, tmin, tmax),
                                     (0, (-n) % fan), value=torch.inf)
        assert (kg <= km.reshape(R, -1, fan).amin(-1)).all()
        assert torch.isinf(kg[:, empty]).all()
        member = group


def _instanced_brute(icl, o, d, tmin, tmax):
    """Every (ray, instance, triangle) in the instance's object space, the
    nearest hit winning, ties to the first instance and then the first
    lane -> (t, tri, inst, a, b)."""
    rows = torch.arange(o.shape[0])
    best_t = torch.clamp(tmax, max=1e12).clone()
    tri = torch.full_like(rows, -1)
    inst = torch.zeros_like(rows)
    a_best, b_best = torch.zeros(o.shape[0]), torch.zeros(o.shape[0])
    for i in range(icl.num_instances):
        proto, row = (int(x) for x in icl.imeta[i])
        off, mlen = (int(x) for x in icl.pmeta[proto])
        tids = icl.tri[off:off + mlen].reshape(-1)
        lane = torch.nonzero(tids >= 0)[:, 0]
        pr = torch.arange(off, off + mlen).repeat_interleave(icl.tri.shape[1])
        pr, col = pr[lane], lane % icl.tri.shape[1]
        corner = [torch.stack([x[3 * pr + k, col] for k in range(3)], -1)
                  for x in (icl.p0, icl.e1, icl.e2)]
        oo, dd = ist.to_object(icl.iminv[i].expand(o.shape[0], 12), o, d)
        p0 = corner[0][None]
        t, a, b, ok = isect.mt_intersect(oo[:, None], dd[:, None], p0,
                                         p0 + corner[1][None],
                                         p0 + corner[2][None])
        ok &= (t >= tmin[:, None]) & (t < best_t[:, None])
        tk, k = torch.where(ok, t, torch.inf).min(1)
        better = tk < best_t
        best_t = torch.where(better, tk, best_t)
        tri = torch.where(better, tids[lane][k].long(), tri)
        inst = torch.where(better, row, inst)
        a_best = torch.where(better, a[rows, k], a_best)
        b_best = torch.where(better, b[rows, k], b_best)
    got = tri >= 0
    return (torch.where(got, best_t, 1e12), tri, inst,
            torch.where(got, a_best, 0.0), torch.where(got, b_best, 0.0))


def _assert_close(got, want, fields):
    """Hit or miss and t agree; tri (and inst) too, but at a tie in t (an
    edge two triangles share), where the sweep takes the lowest id and the
    tracers the first cluster in table order; a and b where tri agrees."""
    f = dict(zip(fields, got))
    w = dict(zip(fields, want))
    np.testing.assert_array_equal(f['tri'] >= 0, w['tri'] >= 0)
    assert int((f['tri'] >= 0).sum()) > R // 10, 'too few hits to test'
    np.testing.assert_allclose(f['t'].numpy(), w['t'].numpy(), rtol=1e-5,
                               atol=1e-5)
    same = f['tri'] == w['tri']
    if 'inst' in f:
        same &= f['inst'] == w['inst']
    assert (~same).float().mean() < 0.02
    for k in ('a', 'b'):
        np.testing.assert_allclose(f[k][same].numpy(), w[k][same].numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize('tracer', ['cluster', 'segment', 'hierarchical',
                                    'segment_table'])
def test_grouped_tracers_match_brute_force(tracer):
    """Camera rays, and rays that pass 1e-4 of a box's extent inside or
    outside an edge of a level-1 group box: the grouped plain tracers
    against a brute-force sweep of every triangle
    (isect.brute_force_trace; for the instanced tables every (instance,
    triangle) in object space). Rays exactly on a group box's edge pass
    exactly by a cluster box's and its triangles' too, where the slab test
    and the sweep round apart; test_walk_matches_flat_scan takes those.
    `segment_table` is a synthetic segment table of 300 instances of
    prototypes of 1-8 pool rows (rays aimed at its triangles in place of
    camera rays)."""
    if tracer == 'segment_table':
        icl = segment_table(300, tuple(range(1, 9)), 4)
        o1, d1 = (torch.from_numpy(x) for x in table_rays(icl, R // 2, 5))
        o2, d2 = (torch.from_numpy(x) for x in grazing_rays(
            ist.segment_levels(icl)[0], R // 2, 7, parallel=False,
            nudge=1e-4))
        o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
        tmin, tmax = torch.full((R,), 1e-3), torch.full((R,), 1e12)
        tmax[::7] = -1.0
        got = ist.trace_ids(icl, o, d, tmin, tmax, False, True)
        _assert_close(got, _instanced_brute(icl, o, d, tmin, tmax),
                      ('t', 'tri', 'inst', 'a', 'b'))
        return
    if tracer == 'cluster':
        scene, cam, _ = cpu(registry.sponza_standin, 32, 24, max_bounces=1,
                            n_spheres=12)
        cl = scene.clusters
        bb = torch.cat([cl.bb_min.T, cl.bb_max.T])
        group = bundle.group_levels(bb, ct.GROUP, ct.DEPTH)[0]
    else:
        make, kw = ((registry.instanced_teapots_standin, {}) if
                    tracer == 'segment' else
                    (registry.forest_standin, dict(n_trees=12)))
        scene, cam, _ = cpu(make, 32, 24, **kw)
        icl = scene.iclusters
        group = ist.segment_levels(icl)[0] if tracer == 'segment' else \
            ict.instance_levels(icl)[0]
    o1, d1, _ = cam_mod.center_rays(cam, 16, R // 32)
    o2, d2 = (torch.from_numpy(x)
              for x in grazing_rays(group, R // 2, 7, parallel=False,
                                    nudge=1e-4))
    o, d = torch.cat([o1, o2]), torch.cat([d1, d2])
    tmin, tmax = torch.full((R,), 1e-3), torch.full((R,), 1e12)
    tmax[::7] = -1.0
    if tracer == 'cluster':
        h = ct.cluster_trace(scene, o, d, 0.0, tmin, tmax)
        hb = isect.brute_force_trace(scene, o, d, 0.0, tmin, tmax)
        _assert_close((h.t, h.tri, h.a, h.b), (hb.t, hb.tri, hb.a, hb.b),
                      ('t', 'tri', 'a', 'b'))
    else:
        plain = ist.iseg_trace if tracer == 'segment' else ict.icluster_trace
        h = plain(scene, o, d, 0.0, tmin, tmax)
        want = _instanced_brute(scene.iclusters, o, d, tmin, tmax)
        _assert_close((h.t, h.tri, h.inst, h.a, h.b), want,
                      ('t', 'tri', 'inst', 'a', 'b'))


_group_levels = bundle.group_levels


def _all_pass_levels(bb6, g, depth):
    """Group levels whose every box holds everything: the walk then keys
    every member, the flat scan."""
    out = []
    for lv in _group_levels(bb6, g, depth):
        lv = lv.clone()
        lv[..., :3, :] = -3e38
        lv[..., 3:, :] = 3e38
        out.append(lv)
    return out


def _counted(fn, monkeypatch=None):
    """Run fn() with the test counters on -> (result, box tests, box tests
    of all-pass group boxes)."""
    flat = [0]
    if monkeypatch is not None:
        keys = ct.slab_keys

        def counting(lo, hi, o, inv, tmin, tmax, valid=None):
            if ct.COUNT_TESTS and bool((lo <= -1e38).all()):
                flat[0] += o.shape[0] * lo.shape[1] if valid is None \
                    else int(valid.sum())
            return keys(lo, hi, o, inv, tmin, tmax, valid)
        monkeypatch.setattr(ct, 'slab_keys', counting)
    ct.TESTS.update(box=0, tri=0)
    ct.COUNT_TESTS = True
    try:
        out = fn()
    finally:
        ct.COUNT_TESTS = False
    return out, ct.TESTS['box'], ct.TESTS['tri'], flat[0]


def _walk_cases():
    """name -> () -> (table, its world box, its walked (6, n) boxes,
    trace(o, d, tmin, tmax, any_hit, time, need_ab) -> outputs) of the
    synthetic tables."""
    def cluster(M, mb):
        cl = cluster_table(M, M, mb=mb)
        real = cl.tri[:, 0] >= 0
        box = (cl.bb_min[real].amin(0), cl.bb_max[real].amax(0))
        return cl, box, torch.cat([cl.bb_min.T, cl.bb_max.T]), \
            lambda *a: ct.trace_ids(cl, *a)

    def instanced(n, protos):
        icl = instanced_table(n, protos, n)
        real = icl.ibb[0] < 1e37
        box = (icl.ibb[:3, real].amin(1), icl.ibb[3:, real].amax(1))
        return icl, box, icl.ibb, \
            lambda o, d, tmin, tmax, any_hit, time, need_ab: \
            ict.trace_ids(icl, o, d, tmin, tmax, any_hit, need_ab)

    def segments(n, protos):
        icl = segment_table(n, protos, n)
        bb = icl.sbb[:, :icl.num_entries]
        box = (bb[:3].amin(1), bb[3:].amax(1))
        return icl, box, bb, \
            lambda o, d, tmin, tmax, any_hit, time, need_ab: \
            ist.trace_ids(icl, o, d, tmin, tmax, any_hit, need_ab)
    return {'clusters_4100_mb': lambda: cluster(4100, True),
            'clusters_65': lambda: cluster(65, False),
            'instances_65_protos_1_8_9_128':
                lambda: instanced(65, (1, 8, 9, 128)),
            'instances_600_protos_9_65': lambda: instanced(600, (9, 65)),
            'segments_65_protos_1_to_8':
                lambda: segments(65, tuple(range(1, 9))),
            'segments_2600_protos_1_5_8': lambda: segments(2600, (1, 5, 8))}


@pytest.mark.parametrize('case', sorted(_walk_cases()))
def test_walk_matches_flat_scan(case, monkeypatch):
    """The plain tracers with their group levels and with all-pass levels
    (the flat scan) return the same bits in every mode, on synthetic
    tables whose sizes are not multiples of 8, 64 or 512 (one above 4,096
    clusters and one above 4,096 segments: the linear top level),
    prototypes of 1, 8, 9, 65 and 128 clusters and segment prototypes of
    1-8 pool rows with padding rows, a quarter of the rays lying in a
    level-1 group box's face planes; dead lanes and any-hit lanes that stop
    early share a 32-ray block."""
    table, box, bb, trace = _walk_cases()[case]()
    o, d = np.concatenate([box_rays(*box, R // 4, 11),
                           table_rays(table, R // 2, 12)], 1)
    o2, d2 = grazing_rays(bundle.group_levels(bb, ct.GROUP, 1)[0], R // 4, 13)
    o, d = (torch.from_numpy(np.concatenate(x)) for x in ((o, o2), (d, d2)))
    time = torch.from_numpy(np.random.default_rng(12).uniform(
        size=R).astype(np.float32))
    tmin = torch.full((R,), 1e-3)
    lane = torch.arange(R)
    for any_hit, need_ab in ((False, False), (True, False), (False, True)):
        far = torch.full((R,), 1e12)
        if any_hit:
            far = torch.where(lane % 3 == 1, 2.0, far)
        tmax = torch.where(lane % 3 == 0, -1.0, far)
        args = (o, d, tmin, tmax, any_hit, time, need_ab)
        got = trace(*args)
        with monkeypatch.context() as m:
            m.setattr(bundle, 'group_levels', _all_pass_levels)
            want = trace(*args)
        assert int((got[1] >= 0).sum()) > R // 10
        for x, y in zip(got, want):
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize('name', ['sponza_12', 'final_forest_reduced',
                                  'final_forest'])
def test_walk_cuts_box_tests(name, monkeypatch):
    """On camera rays the box tests per ray (ops/cluster_trace.TESTS)
    fall below a stated fraction of the flat scan's: 0.5 on the 12-sphere
    atrium (112 clusters); 0.95 on the reduced final forest (93
    instances, flowers and grass interleaved in table order, so most
    groups of 8 span the field), 0.25 on the final forest's 1,905; the
    triangle tests stay as they are."""
    if name == 'sponza_12':
        scene, cam, _ = cpu(registry.sponza_standin, 32, 24, max_bounces=1,
                            n_spheres=12)
        trace, frac = ct.cluster_trace, 0.5
    else:
        kw = FOREST if name == 'final_forest_reduced' else {}
        scene, cam, _ = cpu(registry.final_forest_standin, 32, 24, **kw)
        trace = ict.icluster_trace
        frac = 0.95 if name == 'final_forest_reduced' else 0.25
    o, d, _ = cam_mod.center_rays(cam, 16, R // 16)
    tmax = torch.full((R,), 1e12)
    tmax[::9] = -1.0
    args = (scene, o, d, 0.0, 1e-3, tmax)
    h, box, tri, _ = _counted(lambda: trace(*args))
    monkeypatch.setattr(bundle, 'group_levels', _all_pass_levels)
    hf, box_f, tri_f, group_f = _counted(lambda: trace(*args), monkeypatch)
    flat = box_f - group_f
    np.testing.assert_array_equal(h.t.numpy(), hf.t.numpy())
    np.testing.assert_array_equal(h.tri.numpy(), hf.tri.numpy())
    assert tri == tri_f and tri > 0
    assert 0 < box < frac * flat, (box / R, flat / R)


def test_kernel_digest_covers_headers(tmp_path, monkeypatch):
    """The kernel build's library name hashes every csrc/*.cuh header, so
    an edited header rebuilds; the loader passes the headers and -I csrc
    to nvcc."""
    src = tmp_path / 'csrc'
    shutil.copytree(ck.CSRC, src)
    cu = str(src / 'cluster_trace.cu')
    deps = tuple(sorted(str(p) for p in src.glob('*.cuh')))
    assert any(p.endswith('trace_common.cuh') for p in deps)
    before = native.library_path(cu, ck.NVCC_FLAGS, 'cluster_trace', deps)
    assert before == native.library_path(cu, ck.NVCC_FLAGS, 'cluster_trace',
                                         deps)
    with open(src / 'trace_common.cuh', 'a') as f:
        f.write('\n// edited\n')
    assert before != native.library_path(cu, ck.NVCC_FLAGS, 'cluster_trace',
                                         deps)
    seen = {}

    def fake_build(prefix, path, flags, name, deps=()):
        seen.update(path=path, flags=flags, deps=deps)
        raise RuntimeError('stop before nvcc')
    monkeypatch.setattr(ck, 'nvcc', lambda: 'nvcc')
    monkeypatch.setattr(native, 'build_shared', fake_build)
    with pytest.raises(RuntimeError, match='stop before nvcc'):
        ck.load('cluster_trace', [])
    assert seen['deps'] == ck.headers()
    assert os.path.join(ck.CSRC, 'trace_common.cuh') in seen['deps']
    i = seen['flags'].index('-I')
    assert seen['flags'][i + 1] == ck.CSRC


def test_group_levels_follow_the_tables():
    """The kernel wrappers keep a table's group levels while its box
    tensors are the same and unmodified, and build them anew for new
    tensors or after an in-place edit (the trainer's refresh makes new ones
    each step)."""
    icl = instanced_table(65, (1, 8, 9, 128), 3)
    inst, protos = ick.walk_levels(icl)
    assert ick.walk_levels(icl)[1] is protos
    icl.pbb[0, 0] -= 1.0
    again = ick.walk_levels(icl)[1]
    assert again is not protos and ick.walk_levels(icl)[0] is inst
    for x, y in zip(again, ict.proto_levels(icl.pbb)):
        assert torch.equal(x, y)
    cl = cluster_table(65, 4)
    levels = bundle.cached_levels('test', (cl.bb_min, cl.bb_max),
                                  lambda: ct.box_levels(cl))
    assert bundle.cached_levels('test', (cl.bb_min, cl.bb_max),
                                None) is levels
    moved = dataclasses.replace(cl, bb_min=cl.bb_min - 1.0)
    fresh = bundle.cached_levels('test', (moved.bb_min, moved.bb_max),
                                 lambda: ct.box_levels(moved))
    assert fresh is not levels
    for x, y in zip(fresh, ct.box_levels(moved)):
        assert torch.equal(x, y)


@pytest.mark.parametrize('case', ['segments_65', 'segments_600_big_pool',
                                  'grid', 'final_forest_no_trees'])
def test_segment_kernel_tables(case):
    """What the segment kernel takes besides the table
    (iseg_kernel.walk_tables), against a direct computation: the boxes of
    the real segments and their group levels; each pool row's real lanes,
    which come first in the row (the kernel tests a row up to its count);
    the route: rows with real lanes numbered in row order when their slabs
    fit in RESIDENT_BYTES, else none. The 100,000-instance grid's
    prototype (8 rows, 40 KB) takes the resident route, the final forest's
    without trees (14 of 20 rows, 70 KB) the staged one."""
    if case.startswith('segments'):
        n, protos = (65, (1, 2, 3)) if case == 'segments_65' else \
            (600, (8, 8, 8, 8, 5))
        icl = segment_table(n, protos, 3)
    elif case == 'grid':
        icl = cpu(registry.instanced_grid_standin, 32, 24, n=300)[0] \
            .iclusters
    else:
        icl = cpu(registry.final_forest_standin, 32, 24, n_trees=0,
                  n_flowers=20, grass_grid=8, max_bounces=1)[0].iclusters
    boxes, lanes, slot, n_slots = isk.walk_tables(icl)
    E = icl.num_entries
    assert torch.equal(boxes[0], icl.sbb[:, :E])
    assert len(boxes) == 1 + ist.SEG_DEPTH
    for lv, b in enumerate(boxes[1:], 1):
        assert b.shape == (6, -(-E // ist.SEG_GROUP ** lv))
    tri = icl.tri.numpy()
    for row in range(tri.shape[0]):
        n_real = int((tri[row] >= 0).sum())
        assert int(lanes[row]) == n_real
        assert (tri[row, :n_real] >= 0).all()
    real = [row for row in range(tri.shape[0]) if (tri[row] >= 0).any()]
    C = tri.shape[1]
    fits = len(real) * 10 * C * 4 <= isk.RESIDENT_BYTES
    assert n_slots == (len(real) if fits else 0)
    want = np.full(tri.shape[0], -1)
    if fits:
        want[real] = np.arange(len(real))
    np.testing.assert_array_equal(slot.numpy(), want)
    resident = {'segments_65': True, 'segments_600_big_pool': False,
                'grid': True, 'final_forest_no_trees': False}[case]
    assert (n_slots > 0) == resident
    if case == 'grid':
        assert n_slots == 8
    if case == 'final_forest_no_trees':
        assert (len(real), tri.shape[0]) == (14, 20)
