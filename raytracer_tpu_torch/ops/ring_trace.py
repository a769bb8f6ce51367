"""Geometry-sharded ring tracer: the cluster table cut into one shard a
rank, the rays going round the ring of ranks.

Port of raytracer_tpu/ops/ring_trace.py. Rank i of a D-rank mesh holds
rows [i M / D, (i + 1) M / D) of the table padded by `shard_clusters` to a
multiple of D. A trace runs D rounds: each rank traces the ray state it
holds against its resident shard, then `distributed.ring_shift` sends the
state to rank (r + 1) % D while the geometry stays put. After D hops every
ray is back on its home rank, in its own order, having met every shard.

The JAX ring's local sweep (`_local_sweep`: `_cull` and `_mt_cluster`) is
XLA, not Pallas. Here a round is one call of the cluster tracer that
replaces raytracer_tpu/ops/pallas/cluster_kernel.py:pallas_cluster_trace:
the CUDA kernel (ops/cuda/cluster_kernel.py) for CUDA tensors, its plain
version (ops/cluster_trace.trace_ids) for CPU ones, in the modes the scene
needs (nearest, `cheap_any`, `need_ab`, `mb`). The round's tmax is the
ray's best t so far, so the tracer's strict t < best_t is the JAX sweep's
rule. A miss returns t = MIRO_TMAX and tri = -1; the Hit's inst is 0.

Tie rule: within a shard, table order wins an exact tie in t (the
cluster tracer's rule); across shards, the first shard visited wins, which
is the ray's home rank's, then the next ones in ring order. The JAX sweep
takes near order within a shard, so `tri` may differ from the JAX
package's only at an exact tie in t.

Any-hit rays (`cheap_any`, scenes without alpha maps) that have found a
hit trace the later rounds with tmax = -1 and come home with tri = 1 and
t = min(tmax, MIRO_TMAX), as the cluster tracer returns them. In a scene
with alpha maps every trace is nearest with the winning lane's a and b
(`need_ab`); the alpha test is not in the rounds (the JAX sweep filters
alpha inside its sweep): integrator.trace_fn wraps the whole ring in
ops/cluster_trace.alpha_aware_trace, one ring trace a pass.

What goes round: o, d, tmin, the best t and tri, and a, b (need_ab) and
the ray time (mb), as 4-byte words; the last hop carries only the
results, since the home rank still holds its rays.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import Scene
from ..core.vecmath import MIRO_TMAX
from ..geometry.clusters import NEVER, Clusters
from ..parallel import distributed
from . import cluster_trace as plain
from . import intersect as isect
from .cuda import cluster_kernel as ck
from .intersect import Hit

# ring traces made, and the rounds they ran
TRACES = 0
ROUNDS = 0


@dataclasses.dataclass
class Shard(Clusters):
    """One rank's rows of a sharded cluster table, with the mesh whose
    ranks hold the others."""
    mesh: object = None


def shard_clusters(clusters: Clusters, n: int) -> Clusters:
    """The table padded to a multiple of n rows, byte-equal to the JAX
    package's shard_clusters: padding rows get never-hit point boxes at
    3e37 (ops/bundle.box_union masks them), zero bases and tri = -1. A
    static table's t = 1 tensors stay its t = 0 tensors."""
    M = clusters.tri.shape[0]
    pad = (-M) % n
    done = {}

    def padm(x, fill=0.0):
        if id(x) not in done:
            w = [0, 0] * (x.dim() - 1) + [0, pad]
            done[id(x)] = torch.nn.functional.pad(x, w, value=fill) \
                if pad else x
        return done[id(x)]

    return dataclasses.replace(
        clusters, bb_min=padm(clusters.bb_min, float(NEVER)),
        bb_max=padm(clusters.bb_max, float(NEVER)), p0=padm(clusters.p0),
        e1=padm(clusters.e1), e2=padm(clusters.e2),
        p0_t1=padm(clusters.p0_t1), e1_t1=padm(clusters.e1_t1),
        e2_t1=padm(clusters.e2_t1), tri=padm(clusters.tri, -1))


def local_shard(clusters: Clusters, mesh) -> Shard:
    """This rank's rows of shard_clusters(clusters, mesh.size), as tensors
    of its own."""
    D, i = mesh.size, mesh.rank
    cl = shard_clusters(clusters, D)
    n = cl.tri.shape[0] // D
    done = {}

    def rows(x):
        if id(x) not in done:
            done[id(x)] = x[i * n:(i + 1) * n].clone()
        return done[id(x)]
    fields = {f.name: rows(getattr(cl, f.name)) for f in
              dataclasses.fields(Clusters) if f.name != 'cluster_size'}
    return Shard(**fields, cluster_size=cl.cluster_size, mesh=mesh)


def mesh_of(scene: Scene):
    """The ring of a scene's shard (local_shard's mesh)."""
    cl = scene.clusters
    if not isinstance(cl, Shard):
        raise RuntimeError(
            "intersector 'ring' traces this rank's shard of the cluster "
            "table: every rank calls parallel.distributed.init_from_env(), "
            "then parallel.sharding.make_mesh() and "
            "ops/ring_trace.local_shard(scene.clusters, mesh)")
    return cl.mesh


@torch.no_grad()
def ring_trace(scene: Scene, o, d, time, tmin, tmax, any_hit: bool = False,
               mesh=None) -> Hit:
    """Trace this rank's rays against every rank's shard of the cluster
    table (scene.clusters holds this rank's) -> Hit of the nearest hit, in
    the rays' order. Every rank of the mesh calls it with as many rays."""
    global TRACES, ROUNDS
    mesh = mesh_of(scene) if mesh is None else mesh
    cl = scene.clusters
    mb = scene.has_motion_blur
    cheap, need_ab = plain.modes(scene, any_hit)
    mode = ck.mode_name(any_hit, cheap, need_ab, mb)
    o, d = o.detach().float().contiguous(), d.detach().float().contiguous()
    time, tmin, tmax = isect.ray_inputs(o, time, tmin, tmax)
    R = o.shape[0]
    t = torch.clamp(tmax, max=MIRO_TMAX)
    tri = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    a = b = None
    if need_ab:
        a, b = torch.zeros_like(t), torch.zeros_like(t)
    # the ray state that goes round, and the results that come home
    rays = [o, d, tmin] + ([time] if mb else [])
    D = mesh.size
    for r in range(D):
        o_r, d_r, tmin_r = rays[:3]
        bound = torch.where(tri >= 0, -1.0, t) if cheap else t
        t_r, tri_r, a_r, b_r = ck.trace_ids(
            cl, o_r, d_r, tmin_r, bound.contiguous(), cheap,
            rays[3] if mb else None, mb, need_ab, mode)
        got = tri_r >= 0
        if not cheap:
            t = torch.where(got, t_r, t)
        tri = torch.where(got, tri_r, tri)
        if need_ab:
            a, b = torch.where(got, a_r, a), torch.where(got, b_r, b)
        res = [t, tri] + ([a, b] if need_ab else [])
        if r + 1 < D:
            moved = distributed.ring_shift(rays + res, mesh)
            rays, res = moved[:len(rays)], moved[len(rays):]
        else:
            res = distributed.ring_shift(res, mesh)
        t, tri = res[0], res[1]
        if need_ab:
            a, b = res[2], res[3]
        ROUNDS += 1
    TRACES += 1
    got = tri >= 0
    t = torch.where(got, t, MIRO_TMAX)
    if cheap:       # the cluster tracer's any-hit result
        t = torch.where(got, torch.clamp(tmax, max=MIRO_TMAX), t)
        tri = torch.where(got, 1, -1).to(torch.int32)
    return plain.finish(scene, o, d, time, t, tri, cheap, a, b)


class RingTracer:
    """integrator.trace_fn's tracer for intersector 'ring':
    tracer(o, d, time, tmin, tmax, any_hit) -> Hit through ring_trace over
    the scene's shard, inside the alpha march in a scene with alpha maps.
    The ranks of the shard's mesh must trace alike, so `any_live` is the
    test that ends a loop over traces (radiance's bounces, the alpha
    march's passes): one decision that all ranks share."""

    def __init__(self, scene: Scene):
        if not scene.single_level or scene.clusters is None:
            raise ValueError("intersector 'ring' traces the cluster table "
                             "of a single-level scene")
        self.scene = scene
        self.mesh = mesh_of(scene)

    def any_live(self, flag) -> bool:
        """flag.any() over every rank of the ring (one all_reduce MAX)."""
        return distributed.any_true(flag, self.mesh)

    def once(self, o, d, time, tmin, tmax, any_hit):
        return ring_trace(self.scene, o, d, time, tmin, tmax, any_hit,
                          self.mesh)

    def __call__(self, o, d, time, tmin, tmax, any_hit):
        if not self.scene.has_alpha_maps:
            return self.once(o, d, time, tmin, tmax, any_hit)
        return plain.alpha_aware_trace(self.scene, self.once, o, d, time,
                                       tmin, tmax, any_hit,
                                       any_live=self.any_live)
