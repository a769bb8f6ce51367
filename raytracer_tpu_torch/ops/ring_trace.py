"""Geometry-sharded ring tracer: the cluster table cut into one shard a
rank, the rays going round the ring of ranks.

Port of raytracer_tpu/ops/ring_trace.py. Rank i of a D-rank mesh holds
rows [i M / D, (i + 1) M / D) of the table padded by `shard_clusters` to a
multiple of D. A trace runs D rounds: each rank traces the ray state it
holds against its resident shard, then `distributed.ring_shift` sends the
state to rank (r + 1) % D while the geometry stays put. After D hops every
ray is back on its home rank, in its own order, having met every shard.

The JAX ring's local sweep (`_local_sweep`: `_cull` and `_mt_cluster`) is
XLA, not Pallas. In a scene without alpha maps a round here is one call of
the cluster tracer that replaces
raytracer_tpu/ops/pallas/cluster_kernel.py:pallas_cluster_trace: the CUDA
kernel (ops/cuda/cluster_kernel.py) for CUDA tensors, its plain version
(ops/cluster_trace.trace_ids) for CPU ones, in the modes the scene needs
(nearest, `cheap_any`, `mb`). The round's tmax is the ray's best t so
far, so the tracer's strict t < best_t is the JAX sweep's rule. A miss
returns t = MIRO_TMAX and tri = -1; the Hit's inst is 0.

Tie rule: within a shard, table order wins an exact tie in t (the
cluster tracer's rule); across shards, the first shard visited wins, which
is the ray's home rank's, then the next ones in ring order. The JAX sweep
takes near order within a shard, so `tri` may differ from the JAX
package's only at an exact tie in t.

Any-hit rays (`cheap_any`) that have found a hit trace the later rounds
with tmax = -1 and come home with tri = 1 and t = min(tmax, MIRO_TMAX), as
the cluster tracer returns them.

In a scene with alpha maps a round is the JAX ring's own:
ops/cluster_trace.local_sweep (plain PyTorch on either device), the
near-ordered sweep with the alpha test inside it, from the best state
(t, tri, a, b, found) that came round with the rays and culling against
its t; the whole state goes round (raytracer_tpu/ops/ring_trace.py:
150-159). No alpha march runs around the ring; any-hit returns the first
hit accepted, with its t, a and b, as the JAX ring does.

What goes round: o, d, tmin, the best t and tri, and a, b and found
(alpha maps) and the ray time (mb), as 4-byte words; the last hop carries
only the results, since the home rank still holds its rays.
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
    D = mesh.size
    # the ray state that goes round, and the results that come home
    rays = [o, d, tmin] + ([time] if mb else [])
    if need_ab:
        res = list(plain.init_best(tmax))
    else:
        res = [torch.clamp(tmax, max=MIRO_TMAX),
               torch.full((R,), -1, dtype=torch.int32, device=o.device)]
    for r in range(D):
        o_r, d_r, tmin_r = rays[:3]
        time_r = rays[3] if mb else None
        if need_ab:     # the JAX ring's round, alpha inside the sweep
            res = list(plain.local_sweep(scene, cl, o_r, d_r, time_r,
                                         tmin_r, res, mb, any_hit))
            res[4] = res[4].to(torch.int32)
        else:
            t, tri = res
            bound = torch.where(tri >= 0, -1.0, t) if cheap else t
            t_r, tri_r, _, _ = ck.trace_ids(
                cl, o_r, d_r, tmin_r, bound.contiguous(), cheap, time_r,
                mb, False, mode)
            got = tri_r >= 0
            res = [t if cheap else torch.where(got, t_r, t),
                   torch.where(got, tri_r, tri)]
        if r + 1 < D:
            moved = distributed.ring_shift(rays + res, mesh)
            rays, res = moved[:len(rays)], moved[len(rays):]
        else:
            res = distributed.ring_shift(res, mesh)
        if need_ab:
            res[4] = res[4].bool()
        ROUNDS += 1
    TRACES += 1
    t, tri = res[0], res[1]
    got = tri >= 0
    t = torch.where(got, t, MIRO_TMAX)
    if need_ab:
        return Hit(t=t, tri=tri, inst=torch.zeros_like(tri), a=res[2],
                   b=res[3])
    if cheap:       # the cluster tracer's any-hit result
        t = torch.where(got, torch.clamp(tmax, max=MIRO_TMAX), t)
        tri = torch.where(got, 1, -1).to(torch.int32)
    return plain.finish(scene, o, d, time, t, tri, cheap)


class RingTracer:
    """integrator.trace_fn's tracer for intersector 'ring':
    tracer(o, d, time, tmin, tmax, any_hit) -> Hit through ring_trace over
    the scene's shard. The ranks of the shard's mesh must trace alike, so
    `any_live` is the test that ends radiance's loop over bounces: one
    decision that all ranks share."""

    def __init__(self, scene: Scene):
        if not scene.single_level or scene.clusters is None:
            raise ValueError("intersector 'ring' traces the cluster table "
                             "of a single-level scene")
        self.scene = scene
        self.mesh = mesh_of(scene)

    def any_live(self, flag) -> bool:
        """flag.any() over every rank of the ring (one all_reduce MAX)."""
        return distributed.any_true(flag, self.mesh)

    def __call__(self, o, d, time, tmin, tmax, any_hit):
        return ring_trace(self.scene, o, d, time, tmin, tmax, any_hit,
                          self.mesh)
