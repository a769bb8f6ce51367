"""Smoke run of raytracer_tpu_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the PyTorch/CUDA port's serving paths (forward renders through
`raytracer_tpu_torch.render`) and its training path (forward + backward
through `parallel/sharding.loss_and_grads_scanned`, Adam steps through
`train_step`) at 1920x1080, 1 spp, in phases:

  1. device: the card's name and power limit; TF32 off;
  2. build: the seven CUDA kernels (cluster, segment and hierarchical
     instance trace, the brute-force MT sweep, the wide-BVH walk, each
     with csrc/trace_common.cuh; core/rng's threefry; the take-scatter
     kernel of core/vecmath.take's backward; one nvcc each, all started
     together) and the native host library, all compiled from
     this checkout; each kernel's registers, spills and shared memory
     (ptxas -v);
  3. scene: the 174,724-triangle `sponza_standin` atrium, built on the
     card;
  4. the cluster kernel against its plain PyTorch version, both on the
     card, at 32,768 coherent (camera) and incoherent (random) rays,
     nearest and any-hit, bit for bit, with CUDA-event times (median of 5
     after a warm-up) and the box and triangle tests per ray of the plain
     version's group walk, which is the kernel's; then at the main path's
     wavefront size, the 1080p frame's camera rays (nearest) and one
     sorted bounce from their hits (any-hit), bit for bit;
  5. the full 1080p, 10-bounce path-traced render with intersector 'auto':
     the kernel must carry every trace (launch count > 0, plain-version
     calls 0) and the threefry kernel every draw (as in every render
     phase); then the median wall time of 3 renders;
  6. the same key rendered at 64x48, 3 bounces, on the CPU (plain version)
     and on the card (kernel): the images must agree;
  7. two-level instancing, for `instanced_grid_standin` (100,000
     instances, shallow prototype: the segment kernel) and `forest_standin`
     (200 trees, deep prototypes: the hierarchical instance kernel): the
     kernel against its plain version as in phase 4 (t, tri and inst bit
     for bit), the segment kernel also at the frame's wavefront size, on
     the middle 270 rows of the grid's 1080p camera rays (518,400, nearest)
     and one sorted bounce from their hits (any-hit); then the 1080p render
     at the scene's own settings as in phase 5;
  8. `instanced_teapots_standin` rendered at 64x48 on the CPU and on the
     card, held as in phase 6;
  9. the asset-free `final_forest_standin` at its defaults (204 alpha-cut
     trees, 100 flowers, 1,600 grass clumps, the motion-blurred explosion
     and cannonball, the HDR dome and env map, thin lens, 0.1 shutter):
     the cluster kernel in `mb` + `need_ab` mode on the motion-blurred
     partition and the hierarchical instance kernel in `need_ab` mode on
     the trees, nearest and exact any-hit, each against its plain version
     on the card at 32,768 coherent and incoherent rays (random shutter
     times); then the 1080p frame, with the alpha march's passes and syncs;
 10. the same scene without trees (shallow prototypes only): the segment
     kernel's `need_ab` modes against the plain version, and the frame;
 11. a reduced forest (4 trees, 64x48, 3 steps) rendered on the CPU and on
     the card, held as in phase 6;
 12. the MT kernel against its plain version, both on the card, on the
     12-sphere atrium (8,836 triangles) at 32,768 coherent and incoherent
     rays, nearest and any-hit at the bounds of phase 9 (every 4th lane
     starts past its hit, every 16th is dead), and on a random soup with
     forced ties (duplicate triangles at other ids, in other triangle
     ranges of the kernel's split grid): bit for bit; then at the 'pallas'
     step's wavefront size, the atrium's 2,073,600 camera rays (nearest);
 13. the trainer at full width, bench.py's step on the port
     (`raytracer_tpu_torch.bench`: `sponza_standin`, 10 bounces, all six
     leaves, zero target, median of 5 after a warm-up): the cluster kernel
     carries every trace; the loss and every grad are finite, the
     vertex, kd and rect-power grads nonzero; then 3 Adam steps toward a
     target rendered with kd x 0.7, the same key each step, the
     wavefront sort off: the loss falls;
 14. the 'pallas' path: one fwd+bwd step of the 12-sphere atrium at
     1080p, 10 bounces, with intersector 'pallas': the MT kernel carries
     every trace;
 15. CPU/GPU parity of the loss and grads at 64x48, 3 bounces, for the
     12-sphere atrium under 'auto' and 'pallas';
 16. the edge trainer at full width (diff/edges.loss_and_grads_with_edges
     on `sponza_standin`, 10 bounces, zero target, 4,096 edge samples and
     8,192 GI-edge samples): the cluster kernel carries every trace; the
     median wall of 3 steps, the peak memory, the wall and norm of each
     part (the interior pass, the extra forward render of the adjoint, the
     primary and GI edge terms; the edge terms nonzero); then one
     train_step_with_edges with a finite loss;
 17. shadow edges (shadow_edge_vertex_grad) on `triangle_sphere` at
     1080x1080: the sphere's hard shadow gives a nonzero term;
 18. instanced edges (edge_sampling_vertex_grad) on
     `instanced_teapots_standin` at 1080p through the two-level kernel
     trace_fn picks, with the (instance, edge) pair count;
 19. the edge terms' CPU/GPU parity: the same key and adjoint at 64x48,
     3 bounces, the wavefront sort off, on the 12-sphere atrium (primary
     and GI) and on `triangle_sphere` (primary and shadow): the same
     edges sampled; each
     term within phase 15's rule over the samples whose side radiances
     took the same path and which both devices accepted, with the count
     of the others (at most 5% of the samples, and at least 90% of the
     nonzero samples kept);
 20. adaptive rendering (render_adaptive, levels 1-3, convergence from
     level 2 at a gamma-space change of 0.05) of `sponza_standin` at
     1080p, 10 bounces: the wall (median of 3), the histogram of sample
     counts and the share of pixels active at each level; then its CPU/GPU
     parity at 64x48, 3 bounces, on the 12-sphere atrium: >= 99% of pixels
     with equal counts, and the image within phase 6's rule with the
     wavefront sort off (with it on, one path that turns on an ulp-level
     difference hands the rest of its chunk other random numbers; that
     image's figures are printed, not held);
 21. the procedural stone texture baked at 256x256 on the card and on the
     CPU, within 1e-5;
 22. the wide BVH: `sponza_standin` built with bvh=True on the card (the
     build's seconds and bvh_stats); the BVH kernel against its plain
     version, both on the card, at 32,768 coherent and incoherent rays,
     nearest and any-hit, with the test counters, bit for bit, there and
     on `instanced_teapots_standin` (two levels), `mb_bullet_standin`
     (motion blur), `alpha_leaf_standin` (alpha maps in the walk) and
     `mb_prototype_standin` (a motion-blurred prototype), which 'auto'
     must send to the BVH kernel; the 100,000-instance grid's build with
     its Python TLAS; then the 1080p, 10-bounce frame with intersector
     'bvh' (the BVH kernel carries every trace; median wall of 3, peak
     memory); its centre-of-pixel camera rays' nearest t bit for bit
     with the cluster kernel's; where its wavefronts part from the 'auto' frame's (every
     trace of the 'auto' frame run through both kernels: t, ties,
     barycentrics and any-hit compared; each bounce's sorted wavefront
     compared slot by slot); its image against phase 5's and, both with
     the wavefront sort off, against the 'auto' frame, each under phase
     6's rule; and the CPU/GPU parity of 'bvh' at 64x48, 3 bounces, as
     phase 6;
 23. the loaders at full size: `sponza_standin`'s meshes written as OBJ
     files, read back with load_obj (its seconds) and built on the card:
     every scene array byte-equal to the in-memory build's, and the 1080p
     frame at phase 5's key equal to phase 5's image bit for bit;
 24. the CLI on the card as a subprocess (`python -m
     raytracer_tpu_torch.cli --scene sponza_standin --progressive 1`): 1
     spp with a checkpoint, resumed to 2, against an uninterrupted 2-spp
     run: the same PPM bytes, read back through imageio.load_ppm; then
     `render_with_stats(...).pretty()` for phase 22's scene, with its
     probe's test counters;
 25. several ranks (parallel/worker.py, started as subprocesses with a
     deadline each; a rank that fails or hangs fails the run): two gloo
     ranks on the one card run the 1080p frame through render_sharded,
     held to the single-process per-shard estimator (rank i's chunk with
     fold_in(key, i)) under phase 6's rule, with whether it is bit for
     bit; bench.py's fwd+bwd step through loss_and_grads_scanned(mesh) at
     a 2^20-ray tile (a tile a rank), held to the single-process step at
     that tile under phase 15's rule; two train_step(mesh) steps, finite,
     the ranks holding the same parameters. Each rank's walls, peak
     memory, launches and all-reduce time. Two ranks on one card share its
     SMs: their walls are no scaling figure;
 26. the geometry-sharded ring on the same two ranks: 32,768 incoherent
     rays round the ring, nearest and any-hit, t bit for bit with the
     cluster kernel on the whole table and tri equal except at counted
     ties; the 1080p render_geometry_sharded frame against phase 25's
     (wavefront sort on: the share within phase 6's rule, reported) and,
     sort off, against render_sharded of the same run under phase 6's
     rule; one loss_and_grads_geometry_sharded step against
     loss_and_grads(mesh) under phase 15's rule; the kernel's launches per
     rank (one a round, two a trace) and the hops' bytes and walls;
 27. one NCCL rank runs phase 25's step: bit for bit with the
     single-process step where that step repeats itself bit for bit
     (phase 25 runs it twice), else under phase 15's rule; with two cards
     or more, phases 25-26's frames again with one NCCL rank a card and
     the rays/s against one rank, through raytracer_tpu_torch.scaling
     (with one card the phase says it did not run them);
 28. graft_entry.dryrun_multichip(2) on the card: two train_step(mesh)
     steps and one loss_and_grads(mesh), finite;
 29. the registry's asset scenes: the stand-in asset tree
     (scenes/assets.write_tree: 60 OBJ, TGA and HDR files in the
     reference checkout's layout) written to a temporary directory that
     RT_ASSETS names; every asset scene built on the card at its defaults
     (cornell_pt, cornell_spheres, teapot_blinn, dome_teapot, mb_bullet,
     instanced_teapots, the 100,000-instance instanced_grid, sponza_proxy,
     alpha_leaf, dispersion, final_forest, and the branches
     sponza_proxy(hd=True) and dome_teapot(ground='stone')), with its
     triangles, instances and build seconds;
 30. the main path of the asset scenes: bench.py's scene,
     `sponza_proxy(hd=True)` from the tree (its triangles beside
     `sponza_standin`'s 174,724), at 1080p, 10 bounces, 1 spp: the
     forward frame as in phase 5, then bench.py's fwd+bwd step
     (loss_and_grads_scanned, all six leaves, zero target, median of 3
     after a warm-up, peak memory), each carried by the cluster kernel
     alone (launches > 0, plain calls 0); the loss and every grad finite;
     then one profiled frame and one profiled step (torch.profiler: wall,
     device kernel time, busy share, trace kernels' time);
 31. the two-level asset scenes from the tree: the flagship,
     `final_forest` at its defaults, its 1080p frame (the hierarchical
     instance kernel on every instance, since its tree prototypes are
     deep and its four near trees stand whatever n_trees is, and the
     cluster kernel's `mb` modes on the motion-blurred partition: launches
     by kernel and mode, the alpha march's passes and syncs, the wall,
     peak memory) and a profiled frame; `final_forest(flatten=True,
     n_trees=20)` (single level: the cluster kernel alone); then
     `instanced_grid` at its defaults (100,000 teapots) at 1920x1080: the
     segment kernel alone;
 32. CPU/GPU parity under phase 6's rule, at 64x48 and 3 bounces, of
     `cornell_pt`, `alpha_leaf`, `dispersion` and `final_forest(n_trees=3)`
     from the tree;
 33. intersector 'cluster', the JAX package's XLA tracer
     (ops/cluster_trace.xla_cluster_trace: near-ordered, alpha inside its
     sweep; plain PyTorch, not a kernel) on the full `sponza_proxy(hd=True)`
     at 32,768 coherent and incoherent rays, nearest and any-hit, against
     the cluster kernel (tri equal except at ties of t, exact or within an
     ulp where triangles meet, t within rtol 1e-5 and 1e-6 where tri is
     equal, any-hit alike) and against
     itself on the CPU on every 8th ray (tri equal, t within rtol 1e-6):
     ms a case, loop steps, live rays at every tenth step, peak memory;
 34. the 10-bounce frame of that scene through 'cluster' at XLA_FRAME:
     no kernel launched; the wall, the trace calls, the steps of each
     trace's ray chunks;
 35. `final_forest(flatten=True, n_trees=20)` (alpha maps and motion blur
     in one level) at XLA_FRAME through 'cluster' and through 'auto' (the
     alpha march): walls and the opaque hits of each rule on the camera
     rays (printed: the JAX package's two rules differ); then `alpha_leaf`
     at 64x48 through 'cluster' on the CPU and the card, phase 6's rule;
 36. the 1080p `sponza_proxy(hd=True)` frame through 'cluster_pallas':
     bit for bit with the 'auto' frame of the same key, the same
     cluster-kernel launches by mode;
 37. the alpha ring: two gloo ranks on the one card trace 8,192 rays of
     `alpha_leaf_standin` through 'ring' (each round the JAX ring's
     in-sweep sweep), against 'cluster' on the whole table in one process:
     t equal, tri equal except at exact ties, any-hit alike; no alpha
     march pass on any rank; the hop ms a trace;
 38. the edge gradients against central finite differences on the card
     (diff/edge_fd: the silhouette, shadow, instanced and GI checks of
     tests/test_edge_grad.py at their sizes, samples and tolerances):
     each gradient, finite difference and relative error, held;
 39. `python -m raytracer_tpu_torch.scaling --backend gloo --ranks 1,2
     --size 64` on the one card: its lines, which call themselves no
     scaling figure (both ranks share the card);
 40. RenderSettings.remat: phase 13's 1080p step with remat off and on,
     the same key (median wall of 3 after a warm-up, peak memory, the
     cluster kernel's launches in the forward pass and in the backward
     pass's replays apart): the remat step under phase 15's rule against
     the plain one, at a lower peak; then the 4-spp 1080p step in one
     2^21-pixel tile with remat on (wall, peak memory, a finite loss,
     nonzero grads);
 41. the threefry kernel (csrc/threefry.cu, core/rng on the card): one
     1080p 10-bounce fwd+bwd step of `sponza_standin` (bench.py's step),
     whose every draw it makes (its launches, the cluster kernel's, no
     plain version); then at that step's shapes (R = 2,073,600 rays: the
     bounce loop's (R, 3), the lights' (1, R, 2) along axis 1, the
     camera's (R, 5)) against the plain int64 version on the card, bit
     for bit, with CUDA-event times (median of 5) and its bound (the
     larger of the bytes written over 3.35 TB/s and its integer
     operations over 33.5e12 int32 operations/s); bit for bit also in its
     other modes and layouts (segmented along both axes, random_bits,
     fold_in of a tensor and draws from that batch of keys);
 42. the take-scatter kernel (csrc/grad/take_scatter.cu, the backward of
     core/vecmath.take on the card): one 1080p 10-bounce fwd+bwd step of
     `sponza_standin` (bench.py's step), in which every take gradient
     launches it, in both modes, and index_add_ (its plain version) never
     runs on the card; then, on that step's own gradients and indices of
     its first bounce (the triangle corners (R, 3) into the vertices, `kd`
     and `spec_exp` by material) and on the wavefront sort's permutation of an (R, 3)
     state tensor, the kernel against index_add_ on the card within 1e-5
     x the sum of |contributions| at each entry, with CUDA-event times
     (median of 5) of the kernel, the plain version and index_add_ alone,
     and its bound (bytes over 3.35 TB/s); the sort's backward, the
     gather by the inverse permutation, equal to index_add_, timed.

Each path (phases 5, 7, 9, 10, 13, 14, 16-18, 20, 22's frame, the
motion-blurred prototype's trace, 30, 31, 34-36, 40-42) is driven with every
launch and plain-version count set to 0 just before and read just after;
in phases 25-28 and 37 each rank does so around each of its tasks, and
every rank of 25-28 must have launched the cluster kernel and called no
plain version.
Any failure
raises. The last two lines are the kernels' JSON record (one entry per
kernel and mode group, with the least time its work could take on the
card) and {"ok": true, "device": {...}}. Needs a CUDA device; there is no
CPU mode.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import raytracer_tpu_torch as rt
from raytracer_tpu_torch import bench, convert, graft_entry, native, scaling
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.core import vecmath as vm
from raytracer_tpu_torch.diff import edge_fd, edges as ed
from raytracer_tpu_torch.io import imageio, objload
from raytracer_tpu_torch.ops import cluster_trace as ct
from raytracer_tpu_torch.ops import icluster_trace as ict
from raytracer_tpu_torch.ops import iseg_trace as ist
from raytracer_tpu_torch.ops import mt_trace as tmt
from raytracer_tpu_torch.ops import traverse as ttr
from raytracer_tpu_torch.ops.cuda import bvh_kernel as bvk
from raytracer_tpu_torch.ops.cuda import cluster_kernel as ck
from raytracer_tpu_torch.ops.cuda import icluster_kernel as ick
from raytracer_tpu_torch.ops.cuda import iseg_kernel as isk
from raytracer_tpu_torch.ops.cuda import mt_kernel as mtk
from raytracer_tpu_torch.ops.cuda import rng_kernel as rk
from raytracer_tpu_torch.ops.cuda import take_kernel as tk
from raytracer_tpu_torch.parallel import sharding as ts, worker
from raytracer_tpu_torch.render import camera as cam_mod
from raytracer_tpu_torch.render import integrator
from raytracer_tpu_torch.render.renderer import render_pixels
from raytracer_tpu_torch.scenes import assets, registry
from raytracer_tpu_torch.shading import procedural
from raytracer_tpu_torch.utils import counters, profiling

WIDTH, HEIGHT, BOUNCES = 1920, 1080, 10
N_RAYS = 32_768
PARITY = dict(width=64, height=48, max_bounces=3)
KEY = 2024
# the instanced cells: (scene builder, its instance count with the world
# geometry's identity instance, kernel module, plain module, kernel name,
# the TPU kernel it replaces)
INSTANCED_REPLACES = (
    ('iseg_trace', 'raytracer_tpu/ops/pallas/iseg_kernel.py:271'),
    ('icluster_trace', 'raytracer_tpu/ops/pallas/icluster_kernel.py:309'))
INSTANCED = (
    (registry.instanced_grid_standin, 100_000, isk, ist, 'iseg_trace',
     INSTANCED_REPLACES[0][1]),
    (registry.forest_standin, 201, ick, ict, 'icluster_trace',
     INSTANCED_REPLACES[1][1]))
# the reduced final forest of the CPU/GPU parity check (phase 11)
FOREST_PARITY = dict(n_trees=4, n_flowers=20, grass_grid=8, max_bounces=1)
KERNELS = tuple(counters.KERNELS.values())
PLAINS = counters.PLAINS
# the 'pallas' cells: sponza_standin cut to 12 spheres (8,836 triangles)
MT_SPHERES = 12
MT_REPLACES = 'raytracer_tpu/ops/pallas/mt_kernel.py:122'
# the trainer's CPU/GPU parity check (phase 15)
TRAIN_PARITY = dict(width=64, height=48, max_bounces=3, n_spheres=12)
# the edge trainer's samples (the JAX package's defaults; the GI term
# takes at least 8,192)
EDGE_SAMPLES = 4096
# the several-rank phases (25-28): two ranks on the one card, the fwd+bwd
# step's tile (one per rank at 1080p), a deadline per launch of ranks
RANKS = 2
RANK_TILE = 1 << 20
RANK_TIMEOUT = 400
# the remat phase's (40) samples a pixel in its one 2^21-pixel tile
REMAT_SPP = 4
# render_adaptive's cells: levels 1-3, convergence from level 2
ADAPTIVE = dict(min_subdivs=2, max_subdivs=3, noise_threshold=0.05)


# the least time of a kernel's work on the card: H100 SXM peaks,
# float32 outside the tensor cores and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# H100 SXM peak INT32 rate (the Hopper architecture white paper, 33.5
# TOPS: the INT32 lanes and the integer adds of the FMA pipe together),
# for the threefry kernel (phase 41)
PEAK_INT_OPS = 33.5e12
# launches a CUDA-event time of the threefry kernel spans (a draw takes
# tens of microseconds, near the events' own resolution)
THREEFRY_REPS = 20
# integer operations of one threefry2x32 block: the key's third word (2),
# the first injection (2), 20 rounds of add, rotate and xor (60), five
# injections of three adds (15); then the output: the words' xor, and for
# a float32 uniform the shift, the or and the subtraction
THREEFRY_OPS = dict(uniform=2 + 2 + 60 + 15 + 4, bits=2 + 2 + 60 + 15 + 1)
THREEFRY_SOURCE = 'raytracer_tpu_torch/csrc/threefry.cu'
# not a TPU kernel: on the card it takes the place of the plain int64
# block, which the JAX package does not have (it draws with jax.random)
THREEFRY_REPLACES = 'raytracer_tpu_torch/core/rng.py:43'
TAKE_SOURCE = 'raytracer_tpu_torch/csrc/grad/take_scatter.cu'
# not a TPU kernel: on the card it takes the place of index_add_, the plain
# version (core/vecmath.scatter_rows on the CPU) and autograd's backward of
# index_select, which the JAX package does not have (XLA transposes its
# gathers)
TAKE_REPLACES = 'raytracer_tpu_torch/core/vecmath.py:45'
# float32 operations of one (ray, box) slab test (6 subtractions, 6
# multiplies, 10 min/max, 2 compares), one Moller-Trumbore test
# (ops/mt_trace._mt_block: 45 multiplies, adds and the divide) and the
# `mb` lerp of a lane's nine basis values (9 subtractions, multiplies and
# adds)
BOX_OPS, MT_OPS, LERP_OPS = 24, 45, 27


class Work:
    """Operations and bytes of a kernel's cases, summed: the bound_ms of
    the kernels line is the larger of ops / PEAK_FLOPS (PEAK_INT_OPS for
    the threefry kernel's integer work) and bytes / PEAK_BYTES."""

    def __init__(self):
        self.ops = 0.0
        self.nbytes = 0.0

    def add(self, ops, nbytes):
        self.ops += ops
        self.nbytes += nbytes

    def add_counted(self, plain_call, table_bytes, rays, ray_bytes,
                    mb=False) -> dict:
        """A cluster-table trace: the slab and triangle tests the plain
        version performs for these rays in its group walk, which is the
        kernel's (the off-by-default counters of ops/cluster_trace.py),
        each table byte once, and `ray_bytes` of inputs and outputs per
        ray -> the tests per ray."""
        ct.TESTS.update(box=0, tri=0)
        ct.COUNT_TESTS = True
        try:
            plain_call()
        finally:
            ct.COUNT_TESTS = False
        self.add(ct.TESTS['box'] * BOX_OPS
                 + ct.TESTS['tri'] * (MT_OPS + (LERP_OPS if mb else 0)),
                 table_bytes + rays * ray_bytes)
        return dict(box_tests_per_ray=ct.TESTS['box'] / rays,
                    tri_tests_per_ray=ct.TESTS['tri'] / rays)

    def bound(self, peak_ops: float = PEAK_FLOPS) -> dict:
        f = self.ops / peak_ops * 1e3
        b = self.nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(f, b),
                    bound_by='operations' if f >= b else 'bytes',
                    library_ms=None)


def phase(tag: str, **fields) -> None:
    print(json.dumps({'phase': tag, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5) -> tuple[float, object]:
    """Median CUDA-event time of fn() over `reps` runs after a warm-up."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def test_rays(cam, dev):
    """32k coherent camera rays (a 256x128 image of the bench camera) and
    32k incoherent rays (random points in the atrium, random directions)."""
    o, d, _ = cam_mod.center_rays(cam, 256, N_RAYS // 256)
    rs = np.random.default_rng(KEY)
    lo, hi = np.float32([-9.8, 0.05, -4.9]), np.float32([9.8, 7.9, 4.9])
    o2 = lo + rs.uniform(size=(N_RAYS, 3)) * (hi - lo)
    d2 = rs.normal(size=(N_RAYS, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    dist = rs.uniform(0.5, 12.0, N_RAYS)          # any-hit: shadow distances
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return {'coherent': (o.to(dev), d.to(dev), f(dist)),
            'incoherent': (f(o2), f(d2), f(dist))}


def compare_kernel(scene, cam, dev):
    """Phase 4: kernel vs plain on the card -> (max |dt|, ms, plain ms,
    bound fields)."""
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    work = Work()
    tmax_far = torch.full((N_RAYS,), 1e12, device=dev)
    for kind, (o, d, dist) in test_rays(cam, dev).items():
        for any_hit in (False, True):
            tmax = dist if any_hit else tmax_far
            args = (o, d, 0.0, 1e-3, tmax, any_hit)
            t_k, hk = cuda_ms(lambda: ck.cluster_trace(scene, *args))
            t_p, hp = cuda_ms(lambda: ct.cluster_trace(scene, *args))
            ms_k += t_k
            ms_p += t_p
            # o, d, tmin, tmax in; t, tri out
            tests = work.add_counted(lambda: ct.cluster_trace(scene, *args),
                                     scene.clusters.nbytes, N_RAYS, 40)
            hits = int((hp.tri >= 0).sum())
            bad = int((hk.tri != hp.tri).sum())
            err = float((hk.t - hp.t).abs().max())
            max_err = max(max_err, err)
            phase('kernel_vs_plain', rays=kind, mode='any' if any_hit
                  else 'nearest', n=N_RAYS, hits=hits, tri_mismatch=bad,
                  max_abs_dt=err, kernel_ms=t_k, plain_ms=t_p, **tests)
            # the same walk and arithmetic: bit for bit
            assert bad == 0, f'{kind} any_hit={any_hit}: {bad} rays disagree'
            assert err == 0.0, f'{kind} any_hit={any_hit}: t disagrees'
            assert hits > N_RAYS // 20, 'too few hits to compare'
    return max_err, ms_k, ms_p, work.bound()


def compare_wavefront(tag, trace_k, trace_p, o, d, dev) -> float:
    """A kernel against its plain version at a wavefront size of the main
    path: camera rays o, d (nearest), then one bounce from their hits,
    random directions, sorted as the integrator sorts a wavefront (dead
    rays last, then octant, then the origin's Morton code), stopping at
    0.5-12 units (any-hit): t, tri and inst bit for bit -> max |dt|.
    trace(o, d, tmin, tmax, any_hit) -> Hit. One timed call each after a
    warm-up; the kernels line keeps the 32k-ray cases."""
    R = o.shape[0]
    far = torch.full((R,), 1e12, device=dev)
    rs = np.random.default_rng(KEY + 7)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    first = trace_p(o, d, 1e-3, far, False)
    alive = first.tri >= 0
    d2 = rs.normal(size=(R, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    bounce = integrator._sort_wavefront({
        'o': torch.where(alive[:, None], o + first.t[:, None] * d, o),
        'd': f(d2), 'alive': alive,
        'tmax': torch.where(alive, f(rs.uniform(0.5, 12.0, R)), -1.0)})
    max_err = 0.0
    for mode, (oo, dd, tmax, any_hit) in (
            ('nearest', (o, d, far, False)),
            ('any', (bounce['o'], bounce['d'], bounce['tmax'], True))):
        args = (oo, dd, 1e-3, tmax, any_hit)
        t_k, hk = cuda_ms(lambda: trace_k(*args), reps=1)
        t_p, hp = cuda_ms(lambda: trace_p(*args), reps=1)
        hits = int((hp.tri >= 0).sum())
        bad = int(((hk.tri != hp.tri) | (hk.inst != hp.inst)).sum())
        err = float((hk.t - hp.t).abs().max())
        max_err = max(max_err, err)
        phase(tag, mode=mode, n=R, hits=hits, tri_inst_mismatch=bad,
              max_abs_dt=err, kernel_ms=t_k, plain_ms=t_p)
        assert bad == 0, f'{tag} {mode}: {bad} rays disagree'
        assert err == 0.0, f'{tag} {mode}: t disagrees'
        assert hits > R // 20, 'too few hits to compare'
    return max_err


def compare_full_wavefront(scene, cam, dev) -> float:
    """Phase 4b: the cluster kernel against its plain version at the main
    path's wavefront size, the 1080p frame's 2,073,600 camera rays and one
    sorted bounce from their hits (compare_wavefront)."""
    o, d, _ = cam_mod.center_rays(cam, WIDTH, HEIGHT)
    return compare_wavefront(
        'kernel_vs_plain_1080p',
        lambda *a: ck.cluster_trace(scene, a[0], a[1], 0.0, *a[2:]),
        lambda *a: ct.cluster_trace(scene, a[0], a[1], 0.0, *a[2:]),
        o.to(dev), d.to(dev), dev)


def compare_segment_band(scene, cam, dev) -> float:
    """Phase 7b: the segment kernel against its plain version on the
    middle 270 rows of the grid's 1080p frame (518,400 camera rays, a
    contiguous band: the plain walk stays within seconds) and one sorted
    bounce from their hits (compare_wavefront)."""
    o, d, _ = cam_mod.center_rays(cam, WIDTH, HEIGHT)
    band = slice(WIDTH * (HEIGHT - 270) // 2, WIDTH * (HEIGHT + 270) // 2)
    return compare_wavefront(
        'iseg_kernel_vs_plain_1080p_band',
        lambda *a: isk.iseg_trace(scene, a[0], a[1], 0.0, *a[2:]),
        lambda *a: ist.iseg_trace(scene, a[0], a[1], 0.0, *a[2:]),
        o[band].to(dev), d[band].to(dev), dev)


def instanced_rays(scene, cam, dev):
    """N_RAYS coherent camera rays (every k-th of a 256x128 image of the
    scene's camera) and N_RAYS incoherent rays: random points in the lowest
    2.5 m of the instances' world box, random directions."""
    o, d, _ = cam_mod.center_rays(cam, 256, 128)
    o, d = o[::32768 // N_RAYS], d[::32768 // N_RAYS]
    ibb = scene.iclusters.ibb.cpu()
    real = ibb[0] < 1e37
    lo = ibb[:3, real].amin(1).numpy()
    hi = ibb[3:, real].amax(1).numpy()
    hi[1] = min(hi[1], lo[1] + 2.5)
    rs = np.random.default_rng(KEY)
    o2 = lo + rs.uniform(size=(N_RAYS, 3)) * (hi - lo)
    d2 = rs.normal(size=(N_RAYS, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return {'coherent': (o.to(dev), d.to(dev)), 'incoherent': (f(o2), f(d2))}


def compare_instanced(scene, cam, kernel, plain, dev):
    """Phase 7a: an instanced kernel against its plain version on the card
    -> (max |dt|, ms, plain ms). Nearest rays first; any-hit rays then stop
    at 0.5-1.5 times their nearest hit's distance, so about half of them
    find a hit. t, tri and inst must agree bit for bit."""
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    work = Work()
    rs = np.random.default_rng(KEY + 1)
    for kind, (o, d) in instanced_rays(scene, cam, dev).items():
        near = None
        for any_hit in (False, True):
            if any_hit:
                u = torch.as_tensor(rs.uniform(0.5, 1.5, N_RAYS),
                                    dtype=torch.float32, device=dev)
                tmax = torch.clamp(near * u, max=1e12)
            else:
                tmax = torch.full((N_RAYS,), 1e12, device=dev)
            args = (o, d, 0.0, 1e-3, tmax, any_hit)
            t_k, hk = cuda_ms(lambda: kernel(scene, *args))
            t_p, hp = cuda_ms(lambda: plain(scene, *args))
            ms_k += t_k
            ms_p += t_p
            # o, d, tmin, tmax in; t, tri, inst out
            tests = work.add_counted(lambda: plain(scene, *args),
                                     scene.iclusters.nbytes, N_RAYS, 44)
            if not any_hit:
                near = hp.t
            hits = int((hp.tri >= 0).sum())
            hitmiss = int((hk.valid != hp.valid).sum())
            differ = int(((hk.tri != hp.tri) | (hk.inst != hp.inst)).sum())
            err = float((hk.t - hp.t).abs().max())
            max_err = max(max_err, err)
            phase('instanced_kernel_vs_plain', rays=kind,
                  mode='any' if any_hit else 'nearest', n=N_RAYS, hits=hits,
                  hit_miss_mismatch=hitmiss, tri_inst_mismatch=differ,
                  max_abs_dt=err, kernel_ms=t_k, plain_ms=t_p, **tests)
            # the same walk and arithmetic: bit for bit
            assert hitmiss == 0, f'{kind} any_hit={any_hit}: hit/miss differ'
            assert differ == 0, f'{kind} any_hit={any_hit}: ids disagree'
            assert err == 0.0, f'{kind} any_hit={any_hit}: t disagrees'
            assert hits > N_RAYS // 20, 'too few hits to compare'
    return max_err, ms_k, ms_p, work.bound()


def check_only(kernel, tag) -> int:
    """After a driven path: `kernel` launched, no other kernel, no plain
    version -> its launch count."""
    plain_calls = sum(m.CALLS for m in PLAINS)
    assert kernel.LAUNCHES > 0, f'{tag}: the path never launched the kernel'
    assert plain_calls == 0, f'{tag}: the path called a plain version'
    assert not any(m.LAUNCHES for m in KERNELS if m is not kernel), \
        f'{tag}: the path launched another kernel'
    return kernel.LAUNCHES


def render_cell(scene, cam, st, key, kernel, tag, also=(), **fields):
    """One 1080p render with every launch count set to 0 just before and
    read just after (the kernel, and the kernels in `also`, must carry
    every trace, the plain versions none), then the median wall of 3 ->
    (the kernel's launch count, {kernel module: launches by mode}, both
    read right after that first render, and its image)."""
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    img = rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.LAUNCHES
    plain_calls = sum(m.CALLS for m in PLAINS)
    march = dict(passes=ct.MARCH_PASSES, syncs=ct.MARCH_SYNCS)
    modes = {m: dict(m.MODES) for m in (*KERNELS, rk) if m.LAUNCHES}
    others = [m.LAUNCHES for m in KERNELS
              if m is not kernel and m not in also]
    assert launches > 0, f'{tag}: the render never launched the kernel'
    for m in also:
        assert m.LAUNCHES > 0, f'{tag}: the render never launched {m}'
    assert plain_calls == 0, f'{tag}: the render called a plain tracer'
    assert not any(others), f'{tag}: the render launched another kernel'
    assert rk.LAUNCHES > 0, f'{tag}: the render drew without the kernel'
    check_image(img, (st.height, st.width, 3))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rt.render(scene, cam, st, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    phase(tag, launches=launches, plain_calls=plain_calls, first_s=first_s,
          wall_s=walls, median_s=wall,
          primary_rays_per_s=st.width * st.height / wall,
          mean_radiance=float(img.mean()),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          launches_by_mode={m.__name__.rsplit('.', 1)[-1]: c
                            for m, c in modes.items()},
          alpha_march=march, **fields)
    return launches, modes, img


def mb_rays(cl, cam, dev):
    """N_RAYS coherent rays (a 256 x 128 fan from the camera's eye over the
    motion-blurred table's box) and N_RAYS incoherent ones (from around the
    box to random points in it), each with a random shutter time in the
    camera's [1 - shutter, 1]."""
    real = cl.tri[:, 0] >= 0
    lo = cl.bb_min[real].amin(0).cpu().numpy()
    hi = cl.bb_max[real].amax(0).cpu().numpy()
    rs = np.random.default_rng(KEY + 2)
    gx, gy = np.meshgrid(np.linspace(0, 1, 256),
                         np.linspace(0, 1, N_RAYS // 256))
    tgt = lo + np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.5)],
                        -1) * (hi - lo)
    eye = cam.eye.cpu().numpy()
    d = tgt - eye
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o2 = ctr + rs.normal(size=(N_RAYS, 3)) * ext
    d2 = ctr + rs.uniform(-0.5, 0.5, (N_RAYS, 3)) * ext - o2
    shutter = float(cam.shutter)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    times = lambda: f(1.0 - shutter * rs.uniform(size=N_RAYS))
    return {'coherent': (f(np.tile(eye, (len(d), 1))), f(unit(d)),
                         times()),
            'incoherent': (f(o2), f(unit(d2)), times())}


def march_inputs(near, hit, rs):
    """The ray bounds the render's alpha march and shadow rays give a trace,
    from each ray's nearest hit: every 4th lane that hit starts just past
    it (tmin = 1.0001 t, a march pass after a cutout), every 16th lane is
    done (tmax = -1) -> (tmin, nearest tmax, any-hit tmax), the any-hit
    rays stopping at 0.5-1.5 times their nearest hit's distance."""
    lane = torch.arange(N_RAYS, device=near.device)
    tmin = torch.where(hit & (lane % 4 == 1), near * 1.0001,
                       torch.full_like(near, 1e-3))
    dead = lane % 16 == 3
    u = torch.as_tensor(rs.uniform(0.5, 1.5, N_RAYS), dtype=torch.float32,
                        device=near.device)
    tmax_any = torch.clamp(near * u, max=1e12)
    tmax_near = torch.full_like(near, 1e12)
    return (tmin, torch.where(dead, -1.0, tmax_near),
            torch.where(dead, -1.0, tmax_any))


def compare_modes(tag, trace_k, trace_p, rays, table_bytes, mb=False):
    """A kernel's new modes (nearest and exact any-hit of an alpha scene)
    against its plain version on the card, at the bounds of march_inputs:
    hit or miss, tri, inst, t, a and b must agree bit for bit -> (max
    |error|, ms, plain ms, bound fields)."""
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    work = Work()
    rs = np.random.default_rng(KEY + 4)
    for kind, (o, d, times) in rays.items():
        first = trace_p(o, d, times, 1e-3, 1e12, False)
        tmin, tmax_near, tmax_any = march_inputs(first.t, first.tri >= 0, rs)
        for any_hit in (False, True):
            args = (o, d, times, tmin, tmax_any if any_hit else tmax_near,
                    any_hit)
            t_k, hk = cuda_ms(lambda: trace_k(*args))
            t_p, hp = cuda_ms(lambda: trace_p(*args))
            ms_k += t_k
            ms_p += t_p
            # o, d, time, tmin, tmax in; t, tri, inst, a, b out
            tests = work.add_counted(lambda: trace_p(*args), table_bytes,
                                     N_RAYS, 56, mb)
            hits = int((hp.tri >= 0).sum())
            hitmiss = int((hk.valid != hp.valid).sum())
            differ = int(((hk.tri != hp.tri) | (hk.inst != hp.inst)).sum())
            errs = {f: float((getattr(hk, f) - getattr(hp, f)).abs().max())
                    for f in ('t', 'a', 'b')}
            max_err = max(max_err, *errs.values())
            phase(tag, rays=kind, mode='exact_any' if any_hit else 'nearest',
                  n=N_RAYS, hits=hits, hit_miss_mismatch=hitmiss,
                  tri_inst_mismatch=differ,
                  **{f'max_abs_d{f}': e for f, e in errs.items()},
                  kernel_ms=t_k, plain_ms=t_p, **tests)
            assert hitmiss == 0 and differ == 0, f'{tag} {kind}: ids differ'
            assert max(errs.values()) == 0.0, f'{tag} {kind}: t, a, b differ'
            assert hits > N_RAYS // 20, 'too few hits to compare'
    return max_err, ms_k, ms_p, work.bound()


def forest_cell(dev, key, records, n_trees: int) -> None:
    """Phases 9 and 10: final_forest_standin at 1080p, its new kernel modes
    against their plain versions, and its frame."""
    t0 = time.perf_counter()
    scene, cam, st = registry.final_forest_standin(
        WIDTH, HEIGHT, n_trees=n_trees, device=dev)
    torch.cuda.synchronize()
    icl, mb = scene.iclusters, scene.mb_clusters
    deep = icl.max_proto_clusters > 16
    kernel, plain, name = (ick, ict, 'icluster_trace') if deep else \
        (isk, ist, 'iseg_trace')
    fields = dict(n_trees=n_trees, instances=icl.num_instances,
                  segments=icl.num_entries, clusters=icl.num_clusters,
                  mb_clusters=mb.num_clusters, triangles=scene.num_tris,
                  table_mb=(icl.nbytes + mb.nbytes) / 1e6,
                  texel_mb=scene.textures.data.numel() * 4 / 1e6,
                  instance_kernel=name)
    phase(f'scene_final_forest_{n_trees}', build_s=time.perf_counter() - t0,
          **fields)
    assert scene.has_alpha_maps and scene.has_motion_blur
    if deep:
        err, t_k, t_p, bnd = compare_modes(
            'mb_need_ab_kernel_vs_plain',
            lambda *a: ck.cluster_trace(scene, *a, table=mb, mb=True),
            lambda *a: ct.cluster_trace(scene, *a, table=mb, mb=True),
            mb_rays(mb, cam, dev), mb.nbytes, mb=True)
        records.append(dict(
            name='cluster_trace[mb+need_ab]', route='cuda',
            source='raytracer_tpu_torch/csrc/cluster_trace.cu',
            replaces='raytracer_tpu/ops/pallas/cluster_kernel.py:293',
            max_abs_err=err, ms=t_k, plain_ms=t_p, **bnd))
    inst_rays = instanced_rays(scene, cam, dev)
    shutter = float(cam.shutter)
    rs = np.random.default_rng(KEY + 3)
    rays = {k: (o, d, torch.as_tensor(
        1.0 - shutter * rs.uniform(size=N_RAYS), dtype=torch.float32,
        device=dev)) for k, (o, d) in inst_rays.items()}
    err, t_k, t_p, bnd = compare_modes(
        f'{name}_need_ab_kernel_vs_plain',
        lambda *a: getattr(kernel, name)(scene, *a),
        lambda *a: getattr(plain, name)(scene, *a), rays, icl.nbytes)
    replaces = dict(INSTANCED_REPLACES)[name]
    records.append(dict(name=f'{name}[need_ab]', route='cuda',
                        source=f'raytracer_tpu_torch/csrc/{name}.cu',
                        replaces=replaces, max_abs_err=err, ms=t_k,
                        plain_ms=t_p, **bnd))
    _, modes, _ = render_cell(scene, cam, st, key, kernel,
                           f'render_1080p_final_forest_{n_trees}', also=(ck,),
                           **fields)
    # the new modes' launches in that frame, the only modes it runs
    assert set(modes[ck]) <= {'mb+nearest+need_ab', 'mb+exact_any+need_ab'}
    assert set(modes[kernel]) <= {'nearest+need_ab', 'exact_any+need_ab'}
    if deep:
        records[-2]['launches'] = sum(modes[ck].values())
    records[-1]['launches'] = sum(modes[kernel].values())
    del scene


def check_parity(scene, cam, st, key, kernel, dev, tag, hold=True) -> None:
    """The same key rendered on the CPU (plain version) and on the card
    (kernel; with kernel None, intersector 'cluster' on both): >= 99% of
    pixels within 1e-4 + 1e-3 |x|, mean relative difference < 1e-3 (with
    hold=False the figures are printed, not held)."""
    img_cpu = rt.render(scene, cam, st, key).numpy()
    launches0 = kernel.LAUNCHES if kernel else ct.SWEEPS
    img_gpu = rt.render(scene.to(dev), cam.to(dev), st, key).cpu()
    assert (kernel.LAUNCHES if kernel else ct.SWEEPS) > launches0
    check_image(img_gpu, (st.height, st.width, 3))
    img_gpu = img_gpu.numpy()
    diff = np.abs(img_gpu - img_cpu)
    within = float((diff <= 1e-4 + 1e-3 * np.abs(img_cpu)).all(-1).mean())
    rel = float(diff.mean() / np.abs(img_cpu).mean())
    phase(tag, pixels_within=within, mean_rel_diff=rel, held=hold)
    assert not hold or (within >= 0.99 and rel < 1e-3), \
        f'{tag}: CPU and GPU disagree'


def triangle_soup(dev, T=4133, n_dup=64):
    """A random soup of T triangles (4,133 is 8 tiles and 37 lanes) whose
    last n_dup repeat the first n_dup (exact ties, the lower id wins),
    every 9th a padding lane, and N_RAYS rays aimed at random points of
    random triangles (half at a duplicated one) -> (o, d, (p0, p1, p2,
    valid))."""
    rs = np.random.default_rng(KEY + 6)
    c = rs.uniform(-2, 2, (T, 3))
    p = [c, c + rs.normal(size=(T, 3)) * 0.5, c + rs.normal(size=(T, 3)) * 0.5]
    for x in p:
        x[T - n_dup:] = x[:n_dup]
    valid = np.ones(T, np.int32)
    valid[::9] = 0
    valid[T - n_dup:] = valid[:n_dup]
    k = np.where(rs.uniform(size=N_RAYS) < 0.5,
                 rs.integers(0, n_dup, N_RAYS), rs.integers(0, T, N_RAYS))
    u, v = rs.uniform(size=N_RAYS), rs.uniform(size=N_RAYS)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    tgt = p[0][k] + u[:, None] * (p[1][k] - p[0][k]) \
        + v[:, None] * (p[2][k] - p[0][k])
    d = rs.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = tgt - d * rs.uniform(1, 4, N_RAYS)[:, None]
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return f(o), f(d), (f(p[0]), f(p[1]), f(p[2]),
                        torch.as_tensor(valid, device=dev))


def compare_mt(scene, cam, dev):
    """Phase 12: the MT kernel against its plain version, both on the
    card, on the 12-sphere atrium's triangles at 32,768 coherent and
    incoherent rays (nearest and any-hit, at the bounds of march_inputs)
    and on the random soup with forced ties: t, tri, a and b bit for bit
    -> (max |error|, ms, plain ms, bound fields)."""
    f = scene.geom.face_v.long()
    v = scene.geom.vertices
    tris = (v[f[:, 0]], v[f[:, 1]], v[f[:, 2]],
            torch.ones(f.shape[0], dtype=torch.int32, device=dev))
    rs = np.random.default_rng(KEY + 5)
    cases = []
    for kind, (o, d, _) in test_rays(cam, dev).items():
        first = tmt.mt_trace(o, d, *tris, 1e-3, 1e12)
        tmin, tmax_near, tmax_any = march_inputs(first[0], first[1] >= 0, rs)
        cases += [(kind, 'nearest', o, d, tris, tmin, tmax_near),
                  (kind, 'any', o, d, tris, tmin, tmax_any)]
    o, d, soup = triangle_soup(dev)
    lane = torch.arange(N_RAYS, device=dev)
    cases.append(('soup_ties', 'nearest', o, d, soup,
                  torch.full((N_RAYS,), 1e-3, device=dev),
                  torch.where(lane % 16 == 3, -1.0, 1e12)))
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    work = Work()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, mode, o, d, tr, tmin, tmax in cases:
        args = (o, d, *tr, tmin, tmax)
        t_k, hk = cuda_ms(lambda: mtk.mt_trace(*args))
        t_p, hp = cuda_ms(lambda: tmt.mt_trace(*args))
        ms_k += t_k
        ms_p += t_p
        T = tr[0].shape[0]
        # the triangle ranges of the kernel's grid (mt_kernel.split)
        ranges = -(-T // mtk.split(N_RAYS, T, sms))
        live = int((tmin < tmax).sum())
        # every live (ray, triangle) pair; o, d, tmin, tmax and the corners
        # and flags in, t, tri, a, b out
        work.add(live * T * MT_OPS, N_RAYS * 48 + T * 40)
        hits = int((hp[1] >= 0).sum())
        errs = {n: float((x.double() - y.double()).abs().max())
                for n, x, y in zip(('t', 'tri', 'a', 'b'), hk, hp)}
        max_err = max(max_err, errs['t'], errs['a'], errs['b'])
        phase('mt_kernel_vs_plain', rays=kind, mode=mode, n=N_RAYS,
              triangles=T, live=live, hits=hits,
              tri_mismatch=int((hk[1] != hp[1]).sum()),
              **{f'max_abs_d{n}': e for n, e in errs.items() if n != 'tri'},
              kernel_ms=t_k, plain_ms=t_p, triangle_ranges=ranges)
        assert max(errs.values()) == 0.0, f'{kind} {mode}: kernel != plain'
        assert hits > N_RAYS // 20, 'too few hits to compare'
        if kind == 'soup_ties':
            # the duplicates lie in other ranges of a split grid
            assert ranges > 1 and bool((hk[1] < T - 64).all()), \
                'a tie went to the copy'
    max_err = max(max_err, compare_mt_frame(cam, tris, dev, sms))
    return max_err, ms_k, ms_p, work.bound()


def compare_mt_frame(cam, tris, dev, sms) -> float:
    """Phase 12b: the MT kernel against its plain version at the 'pallas'
    step's wavefront size, the atrium's 2,073,600 camera rays (nearest,
    one unsplit grid; the plain version in slices of 2**18 rays): t, tri,
    a and b bit for bit -> max |error|. One timed call after a warm-up."""
    o, d, _ = cam_mod.center_rays(cam, WIDTH, HEIGHT)
    o, d = o.to(dev), d.to(dev)
    R = o.shape[0]
    tmin = torch.full((R,), 1e-3, device=dev)
    tmax = torch.full((R,), 1e12, device=dev)
    t_k, hk = cuda_ms(lambda: mtk.mt_trace(o, d, *tris, tmin, tmax), reps=1)

    def plain():
        parts = [tmt.mt_trace(o[s:s + (1 << 18)], d[s:s + (1 << 18)], *tris,
                              tmin[s:s + (1 << 18)], tmax[s:s + (1 << 18)])
                 for s in range(0, R, 1 << 18)]
        return [torch.cat(x) for x in zip(*parts)]
    t_p, hp = cuda_ms(plain, reps=1)
    T = tris[0].shape[0]
    ranges = -(-T // mtk.split(R, T, sms))
    errs = {n: float((x.double() - y.double()).abs().max())
            for n, x, y in zip(('t', 'tri', 'a', 'b'), hk, hp)}
    hits = int((hp[1] >= 0).sum())
    phase('mt_kernel_vs_plain_1080p', mode='nearest', n=R, triangles=T,
          hits=hits, tri_mismatch=int((hk[1] != hp[1]).sum()),
          **{f'max_abs_d{n}': e for n, e in errs.items() if n != 'tri'},
          kernel_ms=t_k, plain_ms=t_p, triangle_ranges=ranges)
    assert max(errs.values()) == 0.0, '1080p MT: kernel != plain'
    assert hits > R // 20, 'too few hits to compare'
    return max(errs['t'], errs['a'], errs['b'])


def check_grads(grads, tag, nonzero=('vertices', 'kd', 'rect_power')):
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f'{tag}: {k} grad not finite'
    for k in nonzero:
        assert float(grads[k].abs().max()) > 0, f'{tag}: {k} grad is zero'


def train_cell(scene, cam, st, key) -> None:
    """Phase 13: bench.py's step on the port (raytracer_tpu_torch.bench:
    warm-up, then the median of 5 fwd+bwd steps), every trace through the
    cluster kernel; then 3 Adam steps toward a target rendered with kd
    scaled by 0.7, the same key each step: the loss must fall. The
    descent runs with the wavefront sort off: a sorted wavefront hands the
    random numbers of each bounce out by the hit points' Morton order, so
    the vertex step reshuffles them between rays and the fixed-key noise
    of target and render no longer cancels (the loss rose, 0.53 -> 0.79,
    with the sort on)."""
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    res = bench.run(WIDTH, HEIGHT, BOUNCES, tile=bench.TRAIN_TILE,
                    built=(scene, cam, st))
    launches = check_only(ck, 'train_1080p')
    grads = res.pop('_grads')
    loss = float(res.pop('_loss'))
    assert np.isfinite(loss), 'non-finite loss'
    check_grads(grads, 'train_1080p')
    phase('train_1080p', launches=launches,
          launches_by_mode=dict(ck.MODES), loss=loss,
          grad_max_abs={k: float(g.abs().max()) if g.numel() else 0.0
                        for k, g in grads.items()}, **res)
    print(json.dumps(res), flush=True)
    del grads
    st = dataclasses.replace(st, sort_rays=False)
    target_p = ts.get_params(scene)
    target_p['kd'] = target_p['kd'] * 0.7
    with torch.no_grad():
        target = rt.render(ts.apply_params(scene, target_p), cam, st, key)
    params = ts.get_params(scene)
    # Adam: vertices by 1e-4 a step, the other leaves by 1e-2
    opt = torch.optim.Adam([
        {'params': [params['vertices']], 'lr': 1e-4},
        {'params': [params[k] for k in ts.PARAM_KEYS if k != 'vertices'],
         'lr': 1e-2}])
    losses, walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, loss = ts.train_step(params, opt, scene, cam, st, target,
                                     key, tile=bench.TRAIN_TILE)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    phase('train_adam_3_steps', losses=losses, wall_s=walls,
          kd=params['kd'].tolist())
    assert all(np.isfinite(losses)) and losses[2] < losses[0], \
        'the loss did not fall'


def pallas_cell(dev, key) -> int:
    """Phase 14: one fwd+bwd step of the 12-sphere atrium at 1080p, 10
    bounces, with intersector 'pallas': the MT kernel must carry every
    trace -> its launch count."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, n_spheres=MT_SPHERES,
        ray_tile=bench.TRAIN_TILE, intersector='pallas', device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    loss, grads = ts.loss_and_grads_scanned(ts.get_params(scene), scene, cam,
                                            st, target, key,
                                            tile=bench.TRAIN_TILE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_only(mtk, 'train_1080p_pallas')
    assert bool(torch.isfinite(loss)), 'non-finite loss'
    check_grads(grads, 'train_1080p_pallas')
    phase('train_1080p_pallas', launches=launches, wall_s=wall,
          primary_rays_per_s=WIDTH * HEIGHT / wall, loss=float(loss),
          triangles=scene.num_tris, bounces=BOUNCES,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def train_parity(intersector, key, dev) -> None:
    """Phase 15: loss and grads of the 12-sphere atrium at 64x48, 3
    bounces, against a zero target, on the CPU (plain versions) and on
    the card (kernels): loss within rtol 1e-4, each leaf within rtol 1e-3
    and atol 1e-4 x max|leaf| of the CPU's."""
    host, cam, st = registry.sponza_standin(
        **TRAIN_PARITY, intersector=intersector, device='cpu')
    target = torch.zeros((st.height, st.width, 3))
    lw, gw = ts.loss_and_grads_scanned(ts.get_params(host), host, cam, st,
                                       target, key)
    card = host.to(dev)
    kernel = ck if intersector == 'auto' else mtk
    n0 = kernel.LAUNCHES
    lg, gg = ts.loss_and_grads_scanned(ts.get_params(card), card,
                                       cam.to(dev), st, target.to(dev), key)
    assert kernel.LAUNCHES > n0
    worst = {}
    for k in ts.PARAM_KEYS:
        g, w = gg[k].cpu(), gw[k]
        assert bool(torch.isfinite(g).all()), k
        atol = 1e-4 * float(w.abs().max()) if w.numel() else 0.0
        excess = (g - w).abs() - (atol + 1e-3 * w.abs())
        worst[k] = float(excess.max()) if w.numel() else 0.0
    rel = abs(float(lg) - float(lw)) / abs(float(lw))
    phase('train_cpu_gpu_parity', intersector=intersector,
          loss_cpu=float(lw), loss_gpu=float(lg), loss_rel_diff=rel,
          grad_excess_over_tol=worst)
    assert rel <= 1e-4, f'{intersector}: losses differ'
    assert max(worst.values()) <= 0.0, f'{intersector}: grads differ'


def synced(fn):
    """fn() -> (its result, its wall in s, ended by a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def norm(x) -> float:
    return float(torch.linalg.norm(x.double()))


def edges_cell(dev, key) -> None:
    """Phase 16: the edge trainer at full width on `sponza_standin`."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=bench.TRAIN_TILE,
        device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    params = ts.get_params(scene)
    kw = dict(tile=bench.TRAIN_TILE, edge_samples=EDGE_SAMPLES,
              gi_edges=True)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    (loss, grads), first_s = synced(lambda: ed.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, **kw))
    launches = check_only(ck, 'train_edges_1080p')
    modes = dict(ck.MODES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert np.isfinite(float(loss)), 'non-finite loss'
    check_grads(grads, 'train_edges_1080p')
    walls = [synced(lambda: ed.loss_and_grads_with_edges(
        params, scene, cam, st, target, key, **kw))[1] for _ in range(3)]
    # the parts, one at a time, each ended by a sync
    (_, g_int), t_int = synced(lambda: ts.loss_and_grads_scanned(
        params, scene, cam, st, target, key, tile=bench.TRAIN_TILE))
    (s, dL, keys), t_adj = synced(lambda: ed.edge_adjoint(
        params, scene, cam, st, target, key))
    g_pri, t_pri = synced(lambda: ed.edge_sampling_vertex_grad(
        s, cam, st, dL, keys['primary'], n_samples=EDGE_SAMPLES))
    g_gi, t_gi = synced(lambda: ed.gi_edge_vertex_grad(
        s, cam, st, dL, keys['gi'], n_samples=max(EDGE_SAMPLES, 8192)))
    for tag, g in (('primary', g_pri), ('gi', g_gi)):
        assert bool(torch.isfinite(g).all()), f'{tag} edge term not finite'
        assert norm(g) > 0, f'the {tag} edge term is zero'
    p2 = ts.get_params(scene)
    opt = ts.make_optimizer(p2, lr=1e-4)
    v0 = p2['vertices'].clone()
    p2, loss2 = ed.train_step_with_edges(p2, opt, scene, cam, st, target,
                                         key, tile=bench.TRAIN_TILE,
                                         edge_samples=EDGE_SAMPLES)
    assert np.isfinite(float(loss2)), 'train_step_with_edges: loss'
    assert not torch.equal(p2['vertices'], v0), 'the vertices did not move'
    phase('train_edges_1080p', launches=launches, launches_by_mode=modes,
          first_s=first_s, wall_s=walls, median_s=statistics.median(walls),
          peak_mem_gb=peak, loss=float(loss),
          part_wall_s=dict(interior=t_int, adjoint_render=t_adj,
                           primary_edges=t_pri, gi_edges=t_gi),
          vertex_grad_norm=dict(interior=norm(g_int['vertices']),
                                primary_edges=norm(g_pri),
                                gi_edges=norm(g_gi),
                                combined=norm(grads['vertices'])),
          edges=int(scene.edges.vid.shape[0]), samples=EDGE_SAMPLES,
          gi_samples=max(EDGE_SAMPLES, 8192),
          train_step_with_edges_loss=float(loss2))


def adjoint_of(scene, cam, st, key):
    """dL/dimg of the MSE loss against a black target, from one render."""
    img = rt.render(scene, cam, st, key)
    return 2.0 * img / (st.width * st.height * 3)


def shadow_edges_cell(dev, key) -> None:
    """Phase 17: the shadow boundary term on `triangle_sphere`, 1080^2."""
    scene, cam, st = registry.triangle_sphere(size=HEIGHT, device=dev)
    dL = adjoint_of(scene, cam, st, key)
    counters.reset()
    g, wall = synced(lambda: ed.shadow_edge_vertex_grad(
        scene, cam, st, dL, key, n_samples=EDGE_SAMPLES))
    launches = check_only(ck, 'shadow_edges_1080p')
    assert bool(torch.isfinite(g).all()) and norm(g) > 0, \
        'shadow edges: the term is zero or not finite'
    phase('shadow_edges_1080p', launches=launches,
          launches_by_mode=dict(ck.MODES), wall_s=wall, grad_norm=norm(g),
          vertices_moved=int((g.abs().sum(-1) > 0).sum()),
          edges=int(scene.edges.vid.shape[0]), samples=EDGE_SAMPLES)


def instanced_edges_cell(dev, key) -> None:
    """Phase 18: instanced primary edges on `instanced_teapots_standin`."""
    scene, cam, st = registry.instanced_teapots_standin(
        WIDTH, HEIGHT, device=dev)
    assert scene.edges is not None and scene.edges.pair_inst is not None
    dL = adjoint_of(scene, cam, st, key)
    counters.reset()
    g, wall = synced(lambda: ed.edge_sampling_vertex_grad(
        scene, cam, st, dL, key, n_samples=EDGE_SAMPLES))
    used = [m for m in KERNELS if m.LAUNCHES]
    assert len(used) == 1 and used[0] in (isk, ick), used
    launches = check_only(used[0], 'instanced_edges')
    assert bool(torch.isfinite(g).all()) and norm(g) > 0, \
        'instanced edges: the term is zero or not finite'
    phase('instanced_edges', kernel=used[0].__name__.rsplit('.', 1)[-1],
          launches=launches, launches_by_mode=dict(used[0].MODES),
          wall_s=wall, pairs=int(scene.edges.pair_inst.shape[0]),
          instances=scene.iclusters.num_instances, grad_norm=norm(g),
          samples=EDGE_SAMPLES)


def within_rule(got, want) -> float:
    """The largest excess of |got - want| over phase 15's tolerance, rtol
    1e-3 and atol 1e-4 x max|want| (<= 0 passes)."""
    atol = 1e-4 * float(want.abs().max())
    return float(((got - want).abs() - (atol + 1e-3 * want.abs())).max())


def sample_parity(got, want, verts) -> dict:
    """Two devices' samples of one edge term (ed.EdgeSamples, the same
    key and adjoint): the same edges and positions must be sampled. Left
    out and counted: the samples whose side radiance took another path
    (ulp-level sin/cos and rsqrt differences between the CPU and CUDA
    libraries turn a path, and the wavefront sort then hands the other rays
    of its wavefront other random numbers; a radiance more than 1e-6 +
    1e-4 |f| apart) and those accepted on one device only (a knife-edge
    silhouette or visibility test). The rest, summed onto the vertices ->
    their excess over the rule."""
    got = ed.EdgeSamples(*(getattr(got, f.name).cpu()
                           for f in dataclasses.fields(got)))
    assert torch.equal(got.es, want.es) and torch.equal(got.ss, want.ss)
    off = lambda x, y: ((x - y).abs() > 1e-6 + 1e-4 * y.abs()).any(-1)
    turned = off(got.f_plus, want.f_plus) | off(got.f_minus, want.f_minus)
    flipped = (got.scal == 0) != (want.scal == 0)
    out = turned | flipped
    keep = lambda x: dataclasses.replace(x, scal=torch.where(out, 0.0,
                                                             x.scal))
    live = want.scal != 0
    return dict(samples=int(want.es.numel()), nonzero=int(live.sum()),
                paths_turned=int(turned.sum()),
                nonzero_paths_turned=int((turned & live).sum()),
                accepted_on_one=int(flipped.sum()),
                nonzero_kept=int((live & ~out).sum()),
                excess_all=within_rule(got.grad(verts), want.grad(verts)),
                excess=within_rule(keep(got).grad(verts),
                                   keep(want).grad(verts)))


def edges_parity(key, dev) -> None:
    """Phase 19: each edge term's samples on the CPU (plain versions) and
    on the card (kernels), from the same key and the same adjoint (the
    CPU's render; phase 6 holds the renders), with the wavefront sort off:
    with it on, one side-radiance path that turns on an ulp-level
    difference hands the other rays of its wavefront other random
    numbers (2,242 of 8,192 GI samples' radiances moved so on the card)."""
    samplers = dict(
        primary=(ed.primary_edge_samples, EDGE_SAMPLES),
        shadow=(lambda *a: ed.EdgeSamples.cat(ed.shadow_edge_samples(*a)),
                EDGE_SAMPLES),
        gi=(ed.gi_edge_samples, max(EDGE_SAMPLES, 8192)))
    cases = (('sponza_12', registry.sponza_standin, TRAIN_PARITY,
              ('primary', 'gi')),
             ('triangle_sphere', registry.triangle_sphere, dict(size=64),
              ('primary', 'shadow')))
    for name, make, kw, terms in cases:
        # the wavefront sort off, as in phase 20's image check
        host, cam, st = make(**kw, sort_rays=False, device='cpu')
        target = torch.zeros((st.height, st.width, 3))
        s, dL, keys = ed.edge_adjoint(ts.get_params(host), host, cam, st,
                                      target, key)
        card, cam_d, dL_d = s.to(dev), cam.to(dev), dL.to(dev)
        for term in terms:
            fn, n = samplers[term]
            want = fn(s, cam, st, dL, keys[term], n)
            n0 = ck.LAUNCHES
            got = fn(card, cam_d, st, dL_d, keys[term], n)
            assert ck.LAUNCHES > n0
            res = sample_parity(got, want, s.geom.vertices)
            phase('edges_cpu_gpu_parity', scene=name, term=term, **res)
            assert res['nonzero'] > 0, f'{name}: the {term} term is zero'
            assert res['paths_turned'] + res['accepted_on_one'] \
                <= 0.05 * res['samples'], f'{name} {term}: too many turned'
            assert res['nonzero_kept'] >= 0.9 * res['nonzero'], \
                f'{name} {term}: too few samples agree'
            assert res['excess'] <= 0.0, f'{name}: the {term} term differs'


def adaptive_cell(dev, key) -> None:
    """Phase 20: render_adaptive of `sponza_standin` at 1080p, then its
    CPU/GPU parity at 64x48."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, **ADAPTIVE,
        device=dev)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    (img, cnt), first_s = synced(lambda: rt.render_adaptive(
        scene, cam, st, key, with_counts=True))
    launches = check_only(ck, 'adaptive_1080p')
    modes = dict(ck.MODES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_image(img, (HEIGHT, WIDTH, 3))
    walls = [first_s] + [synced(lambda: rt.render_adaptive(
        scene, cam, st, key))[1] for _ in range(2)]
    values, counts = np.unique(cnt.cpu().numpy(), return_counts=True)
    n = cnt.numel()
    # a pixel's count after level l is 1 + 4 + ... + l^2: the share still
    # active at level l is the share that took level l's samples
    active = {f'level_{lv}': float((cnt >= sum(k * k for k in range(
        1, lv + 1))).sum()) / n for lv in range(1, st.max_subdivs + 1)}
    assert set(values.tolist()) <= {1, 5, 14} and values.min() >= 5
    phase('adaptive_1080p', launches=launches, launches_by_mode=modes,
          first_s=first_s, wall_s=walls, median_s=statistics.median(walls),
          peak_mem_gb=peak, samples_per_pixel=float(cnt.double().mean()),
          count_histogram={int(v): int(c) for v, c in zip(values, counts)},
          active_share=active, mean_radiance=float(img.mean()), **ADAPTIVE)
    host, cam_h, st_h = registry.sponza_standin(**TRAIN_PARITY, **ADAPTIVE,
                                                device='cpu')
    res = {}
    for sort in (True, False):
        st_s = dataclasses.replace(st_h, sort_rays=sort)
        img_c, cnt_c = rt.render_adaptive(host, cam_h, st_s, key,
                                          with_counts=True)
        n0 = ck.LAUNCHES
        img_g, cnt_g = rt.render_adaptive(host.to(dev), cam_h.to(dev), st_s,
                                          key, with_counts=True)
        assert ck.LAUNCHES > n0
        check_image(img_g, (st_h.height, st_h.width, 3))
        img_c, img_g = img_c.numpy(), img_g.cpu().numpy()
        diff = np.abs(img_g - img_c)
        tag = 'sort' if sort else 'unsorted'
        res[tag] = dict(
            pixels_within=float((diff <= 1e-4 + 1e-3 * np.abs(img_c))
                                .all(-1).mean()),
            mean_rel_diff=float(diff.mean() / np.abs(img_c).mean()),
            counts_equal=float((cnt_g.cpu() == cnt_c).double().mean()))
    phase('adaptive_cpu_gpu_parity', **res)
    assert res['sort']['counts_equal'] >= 0.99, 'adaptive: counts disagree'
    assert res['unsorted']['pixels_within'] >= 0.99 \
        and res['unsorted']['mean_rel_diff'] < 1e-3, \
        'adaptive: CPU and GPU disagree'


def stone_cell(dev) -> None:
    """Phase 21: the stone texture baked on the card and on the CPU."""
    gpu, wall = synced(lambda: procedural.bake_stone_texture(size=256,
                                                             device=dev))
    host = procedural.bake_stone_texture(size=256, device='cpu')
    err = float((gpu.cpu() - host).abs().max())
    phase('stone_bake', size=256, wall_s=wall, max_abs_err=err,
          std=float(host.std()))
    assert tuple(gpu.shape) == (256, 256, 3) and err <= 1e-5, \
        'stone texture: the card and the CPU disagree'


def bvh_rays(scene, cam, dev, fan: bool):
    """N_RAYS coherent rays and N_RAYS incoherent ones (from around the
    scene's vertex box to random points in it), each with a random time in
    [0, 1). The coherent ones are a 256 x 128 image of the scene's camera,
    or with `fan` a 256 x 128 fan from its eye over the middle of the
    vertex box (for scenes that fill little of their camera's view)."""
    v = scene.geom.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    rs = np.random.default_rng(KEY + 8)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    if fan:
        gx, gy = np.meshgrid(np.linspace(0, 1, 256),
                             np.linspace(0, 1, N_RAYS // 256))
        tgt = lo + np.stack([gx.ravel(), gy.ravel(),
                             np.full(gx.size, 0.5)], -1) * (hi - lo)
        eye = cam.eye.cpu().numpy()
        o, d = f(np.tile(eye, (len(tgt), 1))), f(unit(tgt - eye))
    else:
        o, d, _ = cam_mod.center_rays(cam, 256, N_RAYS // 256)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o2 = ctr + rs.normal(size=(N_RAYS, 3)) * ext
    d2 = unit(lo + rs.uniform(size=(N_RAYS, 3)) * (hi - lo) - o2)
    times = lambda: f(rs.uniform(size=N_RAYS))
    return {'coherent': (o.to(dev), d.to(dev), times()),
            'incoherent': (f(o2), f(d2), times())}


def compare_bvh(scene, cam, dev, tag, fan=False):
    """Phase 22: the BVH kernel against its plain version, both on the
    card, at 32,768 coherent and incoherent rays, nearest and any-hit,
    with the test counters: t, tri, inst, a, b and the counters bit for
    bit -> (max |error|, ms, plain ms, bound fields). Any-hit rays stop at
    0.5-1.5 times their nearest hit's distance. The bound counts the plain
    walk's box and triangle tests (the kernel's own), each table and
    geometry byte once, and the rays' inputs and outputs."""
    max_err, ms_k, ms_p = 0.0, 0.0, 0.0
    work = Work()
    bvh, g = scene.blas, scene.geom
    table_bytes = sum(x.numel() * x.element_size() for x in (
        bvh.node_min, bvh.node_max, bvh.child, bvh.count, bvh.prim_order,
        g.face_v, g.vertices)) + (g.vertices_t1.numel() * 4
                                  if scene.has_motion_blur else 0)
    mb = scene.has_motion_blur
    rs = np.random.default_rng(KEY + 9)
    for kind, (o, d, tm) in bvh_rays(scene, cam, dev, fan).items():
        tmax = torch.full_like(tm, 1e12)
        for any_hit in (False, True):
            if any_hit:
                u = torch.as_tensor(rs.uniform(0.5, 1.5, N_RAYS),
                                    dtype=torch.float32, device=dev)
                tmax = torch.clamp(hp.t * u, max=1e12)
            args = (o, d, tm, 1e-3, tmax, any_hit, True)
            t_k, (hk, sk) = cuda_ms(lambda: bvk.bvh_trace(scene, *args))
            t_p, (hp, sp) = cuda_ms(lambda: ttr.bvh_trace(scene, *args),
                                    reps=2)
            ms_k += t_k
            ms_p += t_p
            box, tri = int(sp['ray_aabb'].sum()), int(sp['ray_tri'].sum())
            # o, d, time, tmin, tmax in; t, tri, inst, a, b out
            work.add(box * BOX_OPS + tri * (MT_OPS + (LERP_OPS if mb else 0)),
                     table_bytes + N_RAYS * 56)
            hits = int((hp.tri >= 0).sum())
            differ = int(((hk.tri != hp.tri) | (hk.inst != hp.inst)).sum())
            counts = int(((sk['ray_aabb'] != sp['ray_aabb'])
                          | (sk['ray_tri'] != sp['ray_tri'])).sum())
            errs = {f: float((getattr(hk, f) - getattr(hp, f)).abs().max())
                    for f in ('t', 'a', 'b')}
            max_err = max(max_err, *errs.values())
            phase(tag, rays=kind, mode='any' if any_hit else 'nearest',
                  n=N_RAYS, hits=hits, tri_inst_mismatch=differ,
                  counter_mismatch=counts,
                  **{f'max_abs_d{f}': e for f, e in errs.items()},
                  kernel_ms=t_k, plain_ms=t_p, box_tests_per_ray=box / N_RAYS,
                  tri_tests_per_ray=tri / N_RAYS)
            assert differ == 0 and counts == 0, f'{tag} {kind}: ids differ'
            assert max(errs.values()) == 0.0, f'{tag} {kind}: t, a, b differ'
            assert hits > N_RAYS // 20, 'too few hits to compare'
    return max_err, ms_k, ms_p, work.bound()


def sorted_divergence(scene, cam, st, key):
    """Where the sorted 'auto' and 'bvh' frames part. Both frames are
    rendered again with each bounce's wavefront kept after its sort (the
    pixel in each slot, the origins, the live mask), and every trace of
    the 'auto' frame is also run through the BVH kernel on the same rays
    -> (per trace: rays, t differing, equal t on another triangle (a
    tie), the same hit with other barycentrics, any-hit existence
    differing; per bounce: slots holding another pixel's ray, rays whose
    origin or live flag differs, rays whose sort key differs; the two
    images). The first few rays of a
    trace whose t differs come with their origin, direction, both t and
    both triangles."""
    traces, kept = [], {}
    real_step, real_trace = integrator._step, ck.cluster_trace

    def both(sc, o, d, tm, tmin, tmax, any_hit, **kw):
        h = real_trace(sc, o, d, tm, tmin, tmax, any_hit, **kw)
        hb = bvk.bvh_trace(sc, o, d, tm, tmin, tmax, any_hit)
        if any_hit:
            traces.append(dict(mode='any', rays=o.shape[0], exists_differ=int(
                ((h.tri >= 0) != (hb.tri >= 0)).sum())))
        else:
            same = (h.tri == hb.tri) & (h.inst == hb.inst)
            differ = torch.nonzero(h.t != hb.t)[:, 0]
            traces.append(dict(
                mode='nearest', rays=o.shape[0],
                t_differ=int(differ.shape[0]),
                tie_tri_differ=int(((h.t == hb.t) & ~same).sum()),
                ab_differ=int((same & (h.tri >= 0)
                               & ((h.a != hb.a) | (h.b != hb.b))).sum()),
                # the first few rays whose t differs: (cluster, BVH)
                t_examples=[dict(o=o[i].tolist(), d=d[i].tolist(),
                                 t=[float(h.t[i]), float(hb.t[i])],
                                 tri=[int(h.tri[i]), int(hb.tri[i])])
                            for i in differ[:4].tolist()]))
        return h

    def keep(*args, **kw):
        state = real_step(*args, **kw)
        kept[mode].append(dict(key=integrator.sort_key(state),
                               **{k: state[k].clone()
                                  for k in ('pix', 'o', 'alive')}))
        return state

    imgs = {}
    try:
        integrator._step = keep
        for mode in ('auto', 'bvh'):
            kept[mode] = []
            ck.cluster_trace = both if mode == 'auto' else real_trace
            imgs[mode] = rt.render(scene, cam, dataclasses.replace(
                st, intersector=mode), key).cpu()
    finally:
        integrator._step, ck.cluster_trace = real_step, real_trace
    steps = []
    for ka, kb in zip(kept['auto'], kept['bvh']):
        # each ray's state by its pixel, whatever slot it sorted to
        by_pix = [{f: torch.empty_like(k[f]).index_copy_(
            0, k['pix'].long(), k[f]) for f in ('o', 'alive', 'key')}
            for k in (ka, kb)]
        steps.append(dict(
            slots_moved=int((ka['pix'] != kb['pix']).sum()),
            rays_differ=int(((by_pix[0]['o'] != by_pix[1]['o']).any(-1)
                             | (by_pix[0]['alive'] != by_pix[1]['alive']))
                            .sum()),
            keys_differ=int((by_pix[0]['key'] != by_pix[1]['key']).sum())))
    return traces, steps, imgs


def bvh_cell(dev, key, records, frame_auto) -> None:
    """Phase 22: the BVH on `sponza_standin` and the other BVH modes, the
    100,000-instance TLAS build, the 1080p 'bvh' frame and its CPU/GPU
    parity."""
    t0 = time.perf_counter()
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, bvh=True,
        device=dev)
    torch.cuda.synchronize()
    phase('scene_bvh', build_s=time.perf_counter() - t0,
          stack_bound=ttr.stack_bound(scene.blas),
          **profiling.bvh_stats(scene.blas))
    err, t_k, t_p, bnd = compare_bvh(scene, cam, dev, 'bvh_kernel_vs_plain')
    record = dict(name='bvh_trace', route='cuda',
                  source='raytracer_tpu_torch/csrc/bvh_trace.cu',
                  replaces='raytracer_tpu/ops/traverse.py:36 (XLA, not a '
                           'Pallas kernel)',
                  max_abs_err=err, ms=t_k, plain_ms=t_p, **bnd)
    # the other modes: two levels, motion blur, alpha maps in the walk
    for make, kw in ((registry.instanced_teapots_standin,
                      dict(width=WIDTH, height=HEIGHT)),
                     (registry.mb_bullet_standin, dict(size=HEIGHT)),
                     (registry.alpha_leaf_standin, dict(size=HEIGHT))):
        other, cam_o, _ = make(bvh=True, device=dev, **kw)
        e = compare_bvh(other, cam_o, dev,
                        f'bvh_kernel_vs_plain_{make.__name__}', fan=True)[0]
        record['max_abs_err'] = max(record['max_abs_err'], e)
    proto, cam_p, _ = registry.mb_prototype_standin(size=HEIGHT, device=dev)
    assert proto.iclusters is None and proto.mb_clusters is None
    e = compare_bvh(proto, cam_p, dev, 'bvh_kernel_vs_plain_mb_prototype',
                    fan=True)[0]
    record['max_abs_err'] = max(record['max_abs_err'], e)
    o, d, _ = cam_mod.center_rays(cam_p, 256, 128)
    counters.reset()
    h = integrator.trace_fn(proto, rt.RenderSettings())(
        o, d, 0.5, 1e-3, 1e12, False)
    check_only(bvk, 'mb_prototype_auto')
    assert int((h.tri >= 0).sum()) > 0
    del proto
    # the TLAS over 100,000 instances (the Python build, as the JAX
    # package's)
    t0 = time.perf_counter()
    grid, _, _ = registry.instanced_grid_standin(WIDTH, HEIGHT, bvh=True,
                                                 device=dev)
    torch.cuda.synchronize()
    phase('scene_bvh_grid', build_s=time.perf_counter() - t0,
          instances=int(grid.instances.root.shape[0]),
          **profiling.bvh_stats(grid.blas))
    del grid
    # the 1080p 'bvh' frame
    st_bvh = dataclasses.replace(st, intersector='bvh')
    record['launches'], _, img = render_cell(scene, cam, st_bvh, key, bvk,
                                             'render_1080p_bvh')
    records.append(record)
    # its camera rays' nearest hits are the cluster kernel's: t bit for
    # bit, tri apart only where two triangles tie exactly in t
    o, d, _ = cam_mod.center_rays(cam, WIDTH, HEIGHT)
    far = torch.full((o.shape[0],), 1e12, device=dev)
    hb = bvk.bvh_trace(scene, o, d, 0.0, 1e-3, far)
    hc = ck.cluster_trace(scene, o, d, 0.0, 1e-3, far)
    t_differ = int((hb.t != hc.t).sum())
    # where the 'bvh' frame's wavefronts part from the 'auto' frame's: the
    # sort's key is each ray's origin, quantized in the live rays' box,
    # and its permutation decides which random numbers each slot draws
    # (ROADMAP queue 3), so a ray that moves to another slot hands the
    # rays after it other random numbers
    traces, steps, again = sorted_divergence(scene, cam, st, key)
    assert torch.equal(again['auto'], frame_auto) \
        and torch.equal(again['bvh'], img.cpu()), 'a render is not repeatable'
    # against phase 5's 'auto' frame, and both tracers' frames with the
    # wavefront sort off, each under phase 6's rule
    unsorted = {
        mode: rt.render(scene, cam, dataclasses.replace(
            st, intersector=mode, sort_rays=False), key).cpu().numpy()
        for mode in ('auto', 'bvh')}
    shares = {}
    for tag, got, want in (('sorted', img.cpu().numpy(), frame_auto.numpy()),
                           ('unsorted', unsorted['bvh'], unsorted['auto'])):
        diff, scale = np.abs(got - want), np.abs(want)
        shares[tag] = dict(
            pixels_within=float((diff <= 1e-4 + 1e-3 * scale).all(-1)
                                .mean()),
            mean_rel_diff=float(diff.mean() / scale.mean()))
    phase('bvh_frame_vs_auto_frame', camera_rays=o.shape[0],
          t_differ=t_differ, tri_differ=int((hb.tri != hc.tri).sum()),
          traces=traces, bounces=steps, **shares)
    assert t_differ == 0, "the BVH and cluster kernels' nearest t differ"
    for tag, share in shares.items():
        assert share['pixels_within'] >= 0.99 \
            and share['mean_rel_diff'] < 1e-3, \
            f"the {tag} 'bvh' frame and the 'auto' frame disagree"
    host, cam_h, st_h = registry.sponza_standin(**PARITY, bvh=True,
                                                device='cpu')
    check_parity(host, cam_h, dataclasses.replace(st_h, intersector='bvh'),
                 key, bvk, dev, 'cpu_gpu_parity_bvh')
    return scene, cam, st


class ObjBuilder(rt.SceneBuilder):
    """A SceneBuilder that writes each mesh it is given to an OBJ file,
    reads it back with load_obj and adds what it read (the t = 1 pose of a
    motion-blurred mesh as well)."""

    def __init__(self, folder: str):
        super().__init__()
        self.folder = folder
        self.load_s = 0.0
        self.files = 0

    def _round_trip(self, mesh):
        path = os.path.join(self.folder, f'mesh{self.files}.obj')
        self.files += 1
        assets.write_obj(path, mesh)
        t0 = time.perf_counter()
        out = objload.load_obj(path)
        self.load_s += time.perf_counter() - t0
        return out

    def add_mesh(self, mesh, material, mesh_t1=None):
        super().add_mesh(self._round_trip(mesh), material,
                         None if mesh_t1 is None
                         else self._round_trip(mesh_t1))


def loaders_cell(dev, key, frame_auto) -> None:
    """Phase 23: `sponza_standin` written as OBJ files, read back with
    load_obj and built on the card: every table byte-equal to the
    in-memory build's, and the 1080p frame at phase 5's key equal to
    phase 5's image bit for bit."""
    kw = dict(width=WIDTH, height=HEIGHT, max_bounces=BOUNCES, device=dev)
    want, _, _ = registry.sponza_standin(**kw)
    with tempfile.TemporaryDirectory() as folder:
        b = ObjBuilder(folder)
        t0 = time.perf_counter()
        scene, cam, st = registry.sponza_standin(builder=b, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    arrays, static = convert.scene_to_arrays(scene)
    want_arrays, want_static = convert.scene_to_arrays(want)
    assert static == want_static and arrays.keys() == want_arrays.keys()
    differ = [k for k in arrays if arrays[k].dtype != want_arrays[k].dtype
              or arrays[k].tobytes() != want_arrays[k].tobytes()]
    counters.reset()
    img = rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    check_only(ck, 'render_1080p_from_obj')
    same = bool(torch.equal(img.cpu(), frame_auto))
    phase('loaders_1080p', obj_files=b.files, load_obj_s=b.load_s,
          build_s=build_s, triangles=scene.num_tris, arrays=len(arrays),
          arrays_differ=differ, frame_equal_phase5=same)
    assert not differ, f'tables differ after the OBJ round trip: {differ}'
    assert same, "the frame from OBJ files differs from phase 5's"


def cli_cell(tmp: str) -> None:
    """Phase 24: the CLI on the card, as a subprocess: sponza_standin to 1
    spp with a checkpoint, resumed to 2, against an uninterrupted 2-spp
    run: the same PPM bytes, read back through imageio.load_ppm."""
    def run(out, spp, *extra):
        cmd = [sys.executable, '-m', 'raytracer_tpu_torch.cli', '--scene',
               'sponza_standin', '--spp', str(spp), '--progressive', '1',
               '--out', out, *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        assert res.returncode == 0, res.stderr
        return time.perf_counter() - t0
    ckpt = os.path.join(tmp, 'cli.npz')
    walls = dict(
        whole_s=run(os.path.join(tmp, 'whole.ppm'), 2),
        first_s=run(os.path.join(tmp, 'resumed.ppm'), 1, '--ckpt', ckpt),
        resumed_s=run(os.path.join(tmp, 'resumed.ppm'), 2, '--ckpt', ckpt))
    data = {n: open(os.path.join(tmp, f'{n}.ppm'), 'rb').read()
            for n in ('whole', 'resumed')}
    img, _ = imageio.load_ppm(os.path.join(tmp, 'resumed.ppm'))
    phase('cli_1080p', bytes=len(data['resumed']),
          equal=data['whole'] == data['resumed'], shape=list(img.shape),
          mean=float(img.mean()), **walls)
    assert data['whole'] == data['resumed'], 'the resumed CLI run differs'
    assert img.shape == (HEIGHT, WIDTH, 3) and img.mean() > 0


def launch_ranks(n, tasks, backend='gloo', *extra) -> dict:
    """n ranks of parallel/worker.py on the card(s), the 1080p atrium at
    BOUNCES (the parent's caches freed first) -> their arrays, with
    `stats` parsed and the launch's wall; a rank that fails or outlives
    RANK_TIMEOUT fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = worker.launch(
            n, ['--scene', 'sponza_standin', '--scene-kw', json.dumps(dict(
                width=WIDTH, height=HEIGHT, max_bounces=BOUNCES)),
                '--seed', KEY, '--tasks', ','.join(tasks), *extra],
            os.path.join(tmp, 'out.npz'), device='cuda', backend=backend,
            timeout=RANK_TIMEOUT)
    res['stats'] = json.loads(str(res['stats']))
    res['launch_s'] = time.perf_counter() - t0
    return res


def rank_fields(res, task) -> dict:
    """Per rank: the task's wall, peak memory, cluster-kernel launches,
    plain calls and collectives; each rank must have launched the cluster
    kernel, no other kernel and no plain version."""
    out = {k: [] for k in ('walls', 'peak_mem_gb', 'launches',
                           'plain_calls', 'reduce_s', 'reduce_bytes',
                           'gather_s', 'hops', 'hop_bytes', 'hop_s',
                           'ring_traces', 'flags')}
    for r, st in enumerate(res['stats']):
        s = st[task]
        assert s['launches']['cluster_trace'] > 0, \
            f'{task}: rank {r} never launched the cluster kernel'
        assert s['plain_calls'] == 0, f'{task}: rank {r} called a plain version'
        assert not any(v for k, v in s['launches'].items()
                       if k != 'cluster_trace'), f'{task}: another kernel'
        for k in out:
            out[k].append(s['launches']['cluster_trace'] if k == 'launches'
                          else s[k])
    return out


def close_rule(got, want) -> tuple[float, float]:
    """Phase 6's rule: (share of pixels within 1e-4 + 1e-3 |x|, mean
    relative difference)."""
    diff = np.abs(got - want)
    within = float((diff <= 1e-4 + 1e-3 * np.abs(want)).all(-1).mean())
    return within, float(diff.mean() / np.abs(want).mean())


def grads_rule(loss, grads, loss_w, grads_w) -> tuple[float, dict]:
    """Phase 15's rule against (loss_w, grads_w): -> (relative loss
    difference, each leaf's largest excess over rtol 1e-3 and atol 1e-4 x
    max|leaf|)."""
    worst = {}
    for k in ts.PARAM_KEYS:
        g, w = np.asarray(grads[k]), np.asarray(grads_w[k])
        atol = 1e-4 * float(np.abs(w).max()) if w.size else 0.0
        worst[k] = float((np.abs(g - w) - (atol + 1e-3 * np.abs(w))).max()) \
            if w.size else 0.0
    return abs(float(loss) - float(loss_w)) / abs(float(loss_w)), worst


def data_parallel_cell(dev, key) -> dict:
    """Phase 25: two gloo ranks on the one card. The parent computes the
    single-process references first: the per-shard estimator (rank i's
    pixel chunk with fold_in(key, i), one render_pixels call each) and
    the fwd+bwd step at RANK_TILE, twice (is it deterministic?). Then the
    ranks run render_sharded, loss_and_grads_scanned(mesh) at RANK_TILE
    and two train_step(mesh) steps. -> the references and the ranks'
    frame, for phases 26-27."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, device=dev)
    px, py = cam_mod.pixel_coords(WIDTH, HEIGHT, dev)
    shards = []
    for i in range(RANKS):
        with torch.no_grad():
            shards.append(render_pixels(
                scene, cam, st, 1, ts._chunk(px, RANKS, i),
                ts._chunk(py, RANKS, i), rng.fold_in(key, i)).cpu())
    own = torch.cat(shards)[:WIDTH * HEIGHT].reshape(HEIGHT, WIDTH, 3)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    steps, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        loss, grads = ts.loss_and_grads_scanned(
            ts.get_params(scene), scene, cam, st, target, key,
            tile=RANK_TILE)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append((float(loss), {k: g.cpu().numpy()
                                    for k, g in grads.items()}))
        del loss, grads
    peak = torch.cuda.max_memory_allocated() / 1e9
    deterministic = steps[0][0] == steps[1][0] and all(
        np.array_equal(steps[0][1][k], steps[1][1][k]) for k in ts.PARAM_KEYS)
    del scene, target
    res = launch_ranks(RANKS, ['render', 'step', 'train'], 'gloo',
                       '--tile', RANK_TILE, '--repeat', 2)
    img = res['render/img']
    within, rel = close_rule(img, own.numpy())
    bits = bool(np.array_equal(img, own.numpy()))
    loss_rel, worst = grads_rule(res['step/loss'], {
        k: res[f'step/grad/{k}'] for k in ts.PARAM_KEYS}, *steps[0])
    losses = res['train/losses'].tolist()
    sums = {json.dumps(s['train']['param_sum']) for s in res['stats']}
    phase('multi_rank_data_parallel', ranks=RANKS, backend='gloo',
          card='one card shared by both ranks: no scaling figure',
          launch_s=res['launch_s'],
          render=rank_fields(res, 'render'), render_pixels_within=within,
          render_mean_rel_diff=rel, render_bit_for_bit=bits,
          step=rank_fields(res, 'step'), step_tile=RANK_TILE,
          step_loss=float(res['step/loss']), step_loss_rel_diff=loss_rel,
          step_grad_excess_over_tol=worst,
          single_process_step_deterministic=deterministic,
          single_process_step_walls=walls, single_process_peak_mem_gb=peak,
          train=rank_fields(res, 'train'), train_losses=losses,
          train_step_walls=[s['train']['step_walls'] for s in res['stats']])
    check_image(torch.from_numpy(img), (HEIGHT, WIDTH, 3))
    assert within >= 0.99 and rel < 1e-3, 'render_sharded: shards disagree'
    assert loss_rel <= 1e-4 and max(worst.values()) <= 0.0, \
        'the two-rank step disagrees with the single-process one'
    assert np.isfinite(losses).all() and len(sums) == 1, \
        'train_step(mesh): non-finite, or the ranks hold other parameters'
    return dict(img=img, step=steps[0], deterministic=deterministic)


def ring_cell(dev, key, ref) -> None:
    """Phase 26: the geometry-sharded ring on two gloo ranks on the one
    card. The ranks trace 32,768 incoherent rays round the ring (nearest,
    and any-hit to the shadow distances), which the parent holds against
    the cluster kernel on the whole table; then the 1080p
    render_geometry_sharded frame (sort on, against phase 25's
    render_sharded frame; sort off, against the render_sharded frame of
    this run) and one loss_and_grads_geometry_sharded step against
    loss_and_grads(mesh) of this run."""
    scene, cam, _ = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, device=dev)
    o, d, dist = test_rays(cam, dev)['incoherent']
    tmin = torch.full((N_RAYS,), 1e-3, device=dev)
    tmax = torch.full((N_RAYS,), 1e12, device=dev)
    want = ck.cluster_trace(scene, o, d, 0.0, tmin, tmax)
    want_any = ck.cluster_trace(scene, o, d, 0.0, tmin, dist, True)
    del scene
    with tempfile.TemporaryDirectory() as tmp:
        rays = os.path.join(tmp, 'rays.npz')
        np.savez(rays, o=o.cpu().numpy(), d=d.cpu().numpy(),
                 time=np.zeros(N_RAYS, np.float32), tmin=tmin.cpu().numpy(),
                 tmax=tmax.cpu().numpy(), any_tmax=dist.cpu().numpy())
        res = launch_ranks(RANKS, ['ring', 'render_geometry',
                                   'render_geometry@nosort', 'render@nosort',
                                   'step_geometry', 'loss'], 'gloo',
                           '--rays', rays, '--repeat', 2)
    t, tri = res['ring/t'], res['ring/tri']
    t_w, tri_w = want.t.cpu().numpy(), want.tri.cpu().numpy()
    ties = tri != tri_w
    dt = float(np.abs(t - t_w).max())
    any_differ = int(((res['ring/any_tri'] >= 0)
                      != (want_any.tri.cpu().numpy() >= 0)).sum())
    sorted_within, sorted_rel = close_rule(res['render_geometry/img'],
                                           ref['img'])
    within, rel = close_rule(res['render_geometry@nosort/img'],
                             res['render@nosort/img'])
    loss_rel, worst = grads_rule(
        res['step_geometry/loss'],
        {k: res[f'step_geometry/grad/{k}'] for k in ts.PARAM_KEYS},
        res['loss/loss'], {k: res[f'loss/grad/{k}'] for k in ts.PARAM_KEYS})
    frame = rank_fields(res, 'render_geometry')
    phase('ring_1080p', ranks=RANKS, backend='gloo', n=N_RAYS,
          hits=int((tri_w >= 0).sum()), max_abs_dt=dt,
          tri_ties=int(ties.sum()), any_hit_mismatch=any_differ,
          ring=rank_fields(res, 'ring'), launch_s=res['launch_s'],
          frame=frame, frame_sorted_pixels_within=sorted_within,
          frame_sorted_mean_rel_diff=sorted_rel,
          frame_unsorted_pixels_within=within,
          frame_unsorted_mean_rel_diff=rel,
          frame_unsorted=rank_fields(res, 'render_geometry@nosort'),
          data_parallel_unsorted=rank_fields(res, 'render@nosort'),
          step=rank_fields(res, 'step_geometry'), step_loss_rel_diff=loss_rel,
          step_grad_excess_over_tol=worst,
          loss=rank_fields(res, 'loss'),
          hop_mb_per_trace=[b / max(n, 1) / 1e6 for b, n in zip(
              frame['hop_bytes'], frame['ring_traces'])],
          hop_ms_per_trace=[1e3 * s / max(n, 1) for s, n in zip(
              frame['hop_s'], frame['ring_traces'])])
    assert dt == 0.0, 'the ring and the whole-table kernel part in t'
    assert np.array_equal(t[ties], t_w[ties]) and ties.sum() <= N_RAYS // 100
    assert any_differ == 0, 'the ring and the kernel part on any-hit rays'
    for launches, traces in zip(frame['launches'], frame['ring_traces']):
        assert launches == RANKS * traces, 'a ring round without its launch'
    assert within >= 0.99 and rel < 1e-3, 'the unsorted ring frame differs'
    assert loss_rel <= 1e-4 and max(worst.values()) <= 0.0, \
        'the geometry-sharded step differs from loss_and_grads(mesh)'


def nccl_cell(ref) -> None:
    """Phase 27: one NCCL rank runs phase 25's step; it must equal the
    single-process step bit for bit where that step repeats itself bit
    for bit, else within phase 15's rule. Phases 25-26 with one NCCL rank
    a card need at least two cards."""
    res = launch_ranks(1, ['step'], 'nccl', '--tile', RANK_TILE,
                       '--repeat', 2)
    loss, grads = res['step/loss'], {k: res[f'step/grad/{k}']
                                     for k in ts.PARAM_KEYS}
    bits = float(loss) == ref['step'][0] and all(
        np.array_equal(grads[k], ref['step'][1][k]) for k in ts.PARAM_KEYS)
    loss_rel, worst = grads_rule(loss, grads, *ref['step'])
    cards = torch.cuda.device_count()
    phase('nccl', ranks=1, step=rank_fields(res, 'step'),
          launch_s=res['launch_s'], bit_for_bit=bits,
          single_process_step_deterministic=ref['deterministic'],
          loss_rel_diff=loss_rel, grad_excess_over_tol=worst, cards=cards,
          one_rank_a_card='not run: it needs two cards, this machine has '
          f'{cards}' if cards < 2 else 'run')
    if ref['deterministic']:
        assert bits, 'one NCCL rank differs from the single-process step'
    assert loss_rel <= 1e-4 and max(worst.values()) <= 0.0
    if cards >= 2:
        scaling_cell(cards)


def scaling_cell(cards) -> None:
    """Phases 25-26 with one NCCL rank a card, through
    raytracer_tpu_torch.scaling: the data-parallel frame's rays/s on
    `cards` ranks against one."""
    rows = []
    for n in (1, cards):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res = scaling.launch(n, 'sponza_standin', dict(
            width=WIDTH, height=HEIGHT, max_bounces=BOUNCES),
            ['render', 'render_geometry'], 1, backend='nccl', seed=KEY,
            timeout=RANK_TIMEOUT)
        rows.append(scaling.figures(res, 'render'))
        phase('nccl_ranks', ranks=n, render=rank_fields(res, 'render'),
              ring=rank_fields(res, 'render_geometry'))
    phase('nccl_scaling', cards=cards,
          rays_per_s={r['ranks']: r['rays_per_sec'] for r in rows},
          efficiency=scaling.efficiency(rows)['scaling_efficiency'])


def dryrun_cell() -> None:
    """Phase 28: graft_entry.dryrun_multichip(2) on the card."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(RANKS, timeout=RANK_TIMEOUT)
    stats = json.loads(str(res['stats']))
    phase('dryrun_multichip', ranks=RANKS, wall_s=time.perf_counter() - t0,
          losses=res['train/losses'].tolist(), loss=float(res['loss/loss']),
          launches=[s['train']['launches']['cluster_trace'] for s in stats],
          plain_calls=[s['train']['plain_calls'] for s in stats])
    assert all(s['train']['launches']['cluster_trace'] > 0
               and s['train']['plain_calls'] == 0 for s in stats)


# the asset phases (29-32): every registry asset scene at its defaults,
# with the branches sponza_proxy(hd=True) (bench.py's scene) and the
# baked stone ground; the flagship flattened; the parity scenes
ASSET_SCENES = ('cornell_pt', 'cornell_spheres', 'teapot_blinn',
                'dome_teapot', 'mb_bullet', 'instanced_teapots',
                'instanced_grid', 'sponza_proxy', 'alpha_leaf', 'dispersion',
                'final_forest')
ASSET_BUILDS = tuple((name, {}) for name in ASSET_SCENES) + (
    ('sponza_proxy', dict(hd=True)), ('dome_teapot', dict(ground='stone')))
STANDIN_TRIANGLES = 174_724          # sponza_standin's (phase 3)
FLAT_TREES = 20
ASSET_PARITY = (('cornell_pt', {}, ck), ('alpha_leaf', {}, ck),
                ('dispersion', {}, ck), ('final_forest', dict(n_trees=3), ick))
# held with the wavefront sort off: in the closed Cornell room every path
# lives all 3 bounces, and with the sort on one ulp-level difference hands
# the rest of its sorted wavefront other random numbers (on the CPU, the
# eye moved by one ulp leaves 87.5% of pixels within the rule with the
# sort, 100% without); the sorted figures are printed, not held
UNSORTED_PARITY = ('cornell_pt',)


# the __global__ functions of the port's CUDA sources, read from them as
# the benchmark reads them, each kind apart: the trace kernels (csrc/*.cu
# but threefry.cu), the draws' (csrc/threefry.cu) and the gradients'
# (csrc/grad/*.cu)
TRACE_KERNELS = bench.TRACE_KERNELS
RNG_KERNELS = bench.RNG_KERNELS
GRAD_KERNELS = bench._kernel_names(
    sorted(glob.glob(os.path.join(bench.CSRC, 'grad', '*.cu'))))


def busy(fn) -> dict:
    """One run of fn() unprofiled, then one profiled (torch.profiler, CPU
    and CUDA): both walls, the device kernels' time, the device busy share
    (kernel time over each wall), the trace kernels' time and the draw
    and gradient kernels' time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = trace_us = rng_us = grad_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.device_time_total
            dev_us += us
            trace_us += us * any(k in e.name for k in TRACE_KERNELS)
            rng_us += us * any(k in e.name for k in RNG_KERNELS)
            grad_us += us * any(k in e.name for k in GRAD_KERNELS)
    return dict(wall_s=plain_wall, profiled_wall_s=wall,
                device_kernel_s=dev_us / 1e6,
                busy_share=dev_us / 1e6 / plain_wall,
                busy_share_profiled=dev_us / 1e6 / wall,
                trace_kernel_s=trace_us / 1e6, rng_kernel_s=rng_us / 1e6,
                grad_kernel_s=grad_us / 1e6)


def asset_build_cell(dev, tree: str) -> dict:
    """Phase 29: the stand-in asset tree written to `tree` and named by
    RT_ASSETS; every asset scene built on the card at its defaults ->
    {(name, branch): (scene, camera, settings)} of the scenes that later
    phases drive."""
    t0 = time.perf_counter()
    written = assets.write_tree(tree)
    os.environ['RT_ASSETS'] = tree
    phase('asset_tree', files=len(written), write_s=time.perf_counter() - t0)
    keep = {}
    for name, kw in ASSET_BUILDS:
        t0 = time.perf_counter()
        scene, cam, st = registry.make(name, device=dev, **kw)
        torch.cuda.synchronize()
        icl = scene.iclusters
        phase('asset_scene', scene=name, **kw, build_s=time.perf_counter()
              - t0, triangles=scene.num_tris,
              instances=0 if icl is None else icl.num_instances,
              single_level=scene.single_level, bvh=scene.blas is not None,
              width=st.width, height=st.height)
        assert scene.geom.vertices.device == torch.device(dev)
        if (name, kw.get('hd')) in (('sponza_proxy', True),
                                    ('final_forest', None),
                                    ('instanced_grid', None)):
            keep[name] = (scene, cam, st)
        del scene
    return keep


def sponza_proxy_cell(scene, cam, st, key) -> None:
    """Phase 30, the main path: bench.py's scene, `sponza_proxy(hd=True)`
    from the stand-in tree, at 1080p, 10 bounces, 1 spp: the forward
    frame and bench.py's fwd+bwd step (loss_and_grads_scanned, all six
    leaves, zero target, median of 3 after a warm-up), each carried by
    the cluster kernel alone; then one profiled frame and step."""
    assert (st.width, st.height, st.max_bounces) == (WIDTH, HEIGHT, BOUNCES)
    fields = dict(triangles=scene.num_tris,
                  standin_triangles=STANDIN_TRIANGLES,
                  clusters=scene.clusters.num_clusters)
    render_cell(scene, cam, st, key, ck, 'render_1080p_sponza_proxy_hd',
                **fields)
    counters.reset()
    res = bench.run(WIDTH, HEIGHT, BOUNCES, tile=bench.TRAIN_TILE, iters=3,
                    built=(scene, cam, st))
    launches = check_only(ck, 'train_1080p_sponza_proxy_hd')
    grads = res.pop('_grads')
    loss = float(res.pop('_loss'))
    assert np.isfinite(loss), 'non-finite loss'
    check_grads(grads, 'train_1080p_sponza_proxy_hd')
    target = torch.zeros((HEIGHT, WIDTH, 3), device=scene.geom.vertices.device)
    phase('train_1080p_sponza_proxy_hd', launches=launches,
          launches_by_mode=dict(ck.MODES), loss=loss,
          primary_rays_per_s=res['value'], wall_median_s=res['wall_median_s'],
          wall_spread_s=res['wall_spread_s'], warmup_s=res['warmup_s'],
          peak_mem_gb=res['peak_mem_gb'], ray_tile=res['ray_tile'], **fields)
    del grads
    phase('profile_sponza_proxy_hd',
          frame=busy(lambda: rt.render(scene, cam, st, key)),
          step=busy(lambda: ts.loss_and_grads_scanned(
              ts.get_params(scene), scene, cam, st, target, key,
              tile=bench.TRAIN_TILE)))


def flagship_cell(dev, scene, cam, st, key) -> None:
    """Phase 31: `final_forest` from the stand-in tree at its defaults,
    the 1080p frame (the hierarchical instance kernel on every instance:
    its tree prototypes are deep, and the four near trees stand whatever
    n_trees is; the cluster kernel on the motion-blurred partition; the
    alpha march), with launches by kernel and mode, the march's passes
    and syncs, and a profiled frame; then flattened with FLAT_TREES trees
    (single level: the cluster kernel alone)."""
    icl = scene.iclusters
    fields = dict(instances=icl.num_instances, triangles=scene.num_tris,
                  prototype_clusters=icl.max_proto_clusters,
                  mb_clusters=scene.mb_clusters.num_clusters)
    assert icl.max_proto_clusters > 16
    render_cell(scene, cam, st, key, ick, 'render_1080p_final_forest',
                also=(ck,), **fields)
    phase('profile_final_forest',
          frame=busy(lambda: rt.render(scene, cam, st, key)))
    t0 = time.perf_counter()
    scene, cam, st = registry.final_forest(flatten=True, n_trees=FLAT_TREES,
                                           device=dev)
    torch.cuda.synchronize()
    assert scene.single_level
    render_cell(scene, cam, st, key, ck, 'render_1080p_final_forest_flat',
                build_s=time.perf_counter() - t0, triangles=scene.num_tris,
                n_trees=FLAT_TREES)


def grid_cell(scene, cam, st, key) -> None:
    """Phase 31: `instanced_grid` from the stand-in tree at its defaults
    (100,000 teapots, one shallow prototype), its frame at 1920x1080: the
    segment kernel alone."""
    st = dataclasses.replace(st, width=WIDTH, height=HEIGHT,
                             ray_tile=registry.frame_tile(WIDTH, HEIGHT,
                                                          'cuda'))
    icl = scene.iclusters
    assert icl.max_proto_clusters <= 16
    render_cell(scene, cam, st, key, isk, 'render_1080p_instanced_grid',
                instances=icl.num_instances, segments=icl.num_entries,
                triangles=scene.num_tris)


def asset_parity_cell(key, dev) -> None:
    """Phase 32: the asset scenes' CPU/GPU parity under phase 6's rule,
    at 64x48 and 3 bounces."""
    for name, kw, kernel in ASSET_PARITY:
        size = (dict(width=PARITY['width'], height=PARITY['height'])
                if name == 'final_forest' else dict(size=PARITY['width']))
        scene, cam, st = registry.make(name, max_bounces=PARITY['max_bounces'],
                                       device='cpu', **size, **kw)
        st = dataclasses.replace(st, height=PARITY['height'])
        tag = f'cpu_gpu_parity_asset_{name}'
        if name in UNSORTED_PARITY:
            check_parity(scene, cam, st, key, kernel, dev, tag + '_sorted',
                         hold=False)
            st = dataclasses.replace(st, sort_rays=False)
        check_parity(scene, cam, st, key, kernel, dev, tag)


# the last slice's phases (33-39): the size of the XLA cluster tracer's
# ('cluster') frames, the largest 16:9 size whose atrium frame takes under
# a minute (27.1 s at 1080p on an H100 80GB HBM3 at 700 W); every
# CPU_STRIDE-th ray held against the CPU; the alpha ring's rays
XLA_FRAME = (1920, 1080)
CPU_STRIDE = 8
RING_RAYS = 8192


def xla_rays_cell(scene, cam, dev) -> None:
    """Phase 33: intersector 'cluster' (ops/cluster_trace.xla_cluster_trace,
    plain PyTorch) on the full `sponza_proxy(hd=True)` at N_RAYS coherent
    and incoherent rays, nearest and any-hit, against the cluster kernel
    on the same rays (tri equal except at ties of t, t within rtol 1e-5,
    1e-6 where tri is equal; any-hit: hit or miss alike) and against
    itself on the CPU on every CPU_STRIDE-th ray; its ms a case (CUDA
    events, median of 5), loop steps, live rays at every tenth step and
    peak memory. A tie of t is exact, or within an ulp where two
    triangles meet at an edge: the near-ordered sweep stops once the next
    box's key reaches its best t, and may keep the later of the two, as
    the JAX tracer does."""
    host = scene.to('cpu')
    for kind, (o, d, dist) in test_rays(cam, dev).items():
        tmin = torch.full((N_RAYS,), 1e-3, device=dev)
        for any_hit in (False, True):
            tmax = dist if any_hit else torch.full((N_RAYS,), 1e12,
                                                   device=dev)
            args = (o, d, 0.0, tmin, tmax, any_hit)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ct.SWEEP_LIVE = []
            ms, h = cuda_ms(lambda: ct.xla_cluster_trace(scene, *args))
            live, ct.SWEEP_LIVE = ct.SWEEP_LIVE, None
            chunks = len(live) // 6
            peak = torch.cuda.max_memory_allocated() / 1e9
            k_ms, hk = cuda_ms(lambda: ck.cluster_trace(scene, *args))
            t, tri = h.t.cpu().numpy(), h.tri.cpu().numpy()
            t_k, tri_k = hk.t.cpu().numpy(), hk.tri.cpu().numpy()
            hit = tri_k >= 0
            assert np.array_equal(tri >= 0, hit), f'{kind}: hits differ'
            sub = slice(None, None, CPU_STRIDE)
            t0 = time.perf_counter()
            hc = ct.xla_cluster_trace(host, *(x[sub].cpu() for x in (o, d)),
                                      0.0, tmin[sub].cpu(), tmax[sub].cpu(),
                                      any_hit)
            cpu_s = time.perf_counter() - t0
            cpu_tri = int((hc.tri.numpy() != tri[sub]).sum())
            cpu_dt = float((np.abs(hc.t.numpy() - t[sub])
                            / np.abs(t[sub])).max())
            fields = dict(rays=kind, mode='any' if any_hit else 'nearest',
                          n=N_RAYS, clusters=scene.clusters.num_clusters,
                          ms=ms, kernel_ms=k_ms, hits=int(hit.sum()),
                          chunks=chunks, steps=[len(c) for c in
                                                live[:chunks]],
                          live_every_10th=live[0][::10], peak_mem_gb=peak,
                          cpu_rays=N_RAYS // CPU_STRIDE, cpu_s=cpu_s,
                          cpu_tri_differ=cpu_tri, cpu_max_rel_dt=cpu_dt)
            if any_hit:
                phase('xla_cluster_rays', **fields)
            else:
                rel = np.abs(t - t_k)[hit] / np.abs(t_k)[hit]
                same = (tri == tri_k)[hit]
                ties = np.nonzero(tri != tri_k)[0]
                phase('xla_cluster_rays', **fields,
                      tri_ties=len(ties), tie_rays=ties[:32].tolist(),
                      exact_ties=int((t[ties] == t_k[ties]).sum()),
                      max_rel_dt=float(rel.max()),
                      max_rel_dt_same_tri=float(rel[same].max()))
                # where tri differs, t ties: exactly, or within an ulp where
                # two triangles meet at an edge (the near-ordered sweep can
                # stop at the later of the two, as the JAX tracer does)
                assert (np.abs(t - t_k)[ties] <= 1e-6 * t_k[ties]).all(), \
                    f'{kind}: tri differs from the kernel off a tie of t'
                assert len(ties) <= N_RAYS // 1000
                assert rel.max() <= 1e-5 and rel[same].max() <= 1e-6
            assert cpu_tri == 0 and cpu_dt <= 1e-6, \
                f'{kind}: the card and the CPU part'
    del host


def xla_frame_cell(scene, cam, st, key) -> None:
    """Phase 34: a 10-bounce frame of `sponza_proxy(hd=True)` through
    'cluster' at XLA_FRAME: no kernel, every trace a call of the XLA
    tracer; the wall, the trace calls and the loop steps of each trace's
    ray chunks."""
    W, H = XLA_FRAME
    st = dataclasses.replace(st, width=W, height=H, intersector='cluster',
                             ray_tile=registry.frame_tile(W, H, 'cuda'))
    counters.reset()
    ct.SWEEP_LIVE = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = rt.render(scene, cam, st, key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    live, ct.SWEEP_LIVE = ct.SWEEP_LIVE, None
    assert not any(m.LAUNCHES for m in KERNELS), 'a kernel ran'
    assert sum(m.CALLS for m in PLAINS) == 0 and ct.SWEEPS > 0
    check_image(img, (H, W, 3))
    per = len(live) // ct.SWEEPS     # every trace has the tile's rays
    phase('xla_cluster_frame', width=W, height=H, bounces=st.max_bounces,
          wall_s=wall, primary_rays_per_s=W * H / wall,
          trace_calls=ct.SWEEPS, chunks_per_trace=per,
          steps_per_trace=[sum(len(c) for c in live[i:i + per])
                           for i in range(0, len(live), per)],
          most_steps_in_a_chunk=max(len(c) for c in live),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          mean_radiance=float(img.mean()))


def xla_alpha_cell(dev, key) -> None:
    """Phase 35: `final_forest(flatten=True, n_trees=FLAT_TREES)` from the
    tree (single level, alpha maps, motion blur) at XLA_FRAME: a frame
    through 'cluster' (alpha inside the sweep) and one through 'auto' (the
    alpha march around the cluster kernel), with the opaque hits of each
    rule on the centre camera rays (the rules differ: printed, not held);
    then the CPU/GPU parity of `alpha_leaf` at 64x48 through 'cluster'
    under phase 6's rule."""
    W, H = XLA_FRAME
    scene, cam, st = registry.final_forest(
        W, H, flatten=True, n_trees=FLAT_TREES, device=dev)
    assert scene.single_level and scene.has_alpha_maps \
        and scene.has_motion_blur
    o, d, tm = cam_mod.center_rays(cam, W, H)
    fields = {}
    for mode in ('cluster', 'auto'):
        s = dataclasses.replace(st, intersector=mode)
        counters.reset()
        t0 = time.perf_counter()
        img = rt.render(scene, cam, s, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_image(img, (H, W, 3))
        fields[mode] = dict(wall_s=wall, sweeps=ct.SWEEPS,
                            launches=ck.LAUNCHES,
                            march_passes=ct.MARCH_PASSES,
                            mean_radiance=float(img.mean()))
        h = integrator.trace_fn(scene, s)(o, d, tm, 1e-3, 1e12, False)
        fields[mode]['camera_opaque_hits'] = int((h.tri >= 0).sum())
    phase('xla_cluster_alpha', width=W, height=H, triangles=scene.num_tris,
          camera_rays=W * H, **fields)
    assert fields['cluster']['launches'] == 0 < fields['cluster']['sweeps']
    assert fields['auto']['launches'] > 0 == fields['auto']['sweeps']
    del scene
    scene, cam, st = registry.alpha_leaf(
        PARITY['width'], max_bounces=PARITY['max_bounces'], device='cpu',
        intersector='cluster')
    st = dataclasses.replace(st, height=PARITY['height'])
    check_parity(scene, cam, st, key, None, dev,
                 'cpu_gpu_parity_asset_alpha_leaf_cluster')


def cluster_pallas_cell(scene, cam, st, key) -> None:
    """Phase 36: the 1080p `sponza_proxy(hd=True)` frame through
    'cluster_pallas' bit for bit with the 'auto' frame of the same key,
    with the same cluster-kernel launches by mode."""
    out = {}
    for mode in ('auto', 'cluster_pallas'):
        counters.reset()
        img = rt.render(scene, cam, dataclasses.replace(st, intersector=mode),
                        key)
        torch.cuda.synchronize()
        out[mode] = (img, check_only(ck, mode), dict(ck.MODES))
    same = bool(torch.equal(out['auto'][0], out['cluster_pallas'][0]))
    phase('cluster_pallas_route', width=st.width, height=st.height,
          bit_for_bit=same, launches=out['cluster_pallas'][1],
          launches_by_mode=out['cluster_pallas'][2],
          auto_launches=out['auto'][1])
    assert same and out['auto'][1:] == out['cluster_pallas'][1:], \
        "'cluster_pallas' is not routed as 'auto'"


def ring_alpha_cell(dev) -> None:
    """Phase 37: two gloo ranks on the one card trace RING_RAYS rays of
    `alpha_leaf_standin` round the ring ('ring': each round the JAX ring's
    in-sweep alpha rule), against one rank's 'cluster' on the whole table:
    tri equal except at exact ties, t equal, any-hit alike; no alpha march
    pass on any rank; the hop ms a trace."""
    scene, _, _ = registry.alpha_leaf_standin(64, device=dev)
    rs = np.random.default_rng(KEY)
    v = scene.geom.vertices.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = (ctr + rs.normal(size=(RING_RAYS, 3)) * ext).astype(np.float32)
    d = (lo + rs.uniform(size=(RING_RAYS, 3)) * (hi - lo) - o)
    dist = np.linalg.norm(d, axis=-1).astype(np.float32)
    d = (d / dist[:, None]).astype(np.float32)
    rays = dict(o=o, d=d, time=np.zeros(RING_RAYS, np.float32),
                tmin=np.full(RING_RAYS, 1e-3, np.float32),
                tmax=np.full(RING_RAYS, 1e12, np.float32), any_tmax=dist)
    card = {k: torch.from_numpy(x).to(dev) for k, x in rays.items()}
    want = ct.xla_cluster_trace(scene, card['o'], card['d'], 0.0,
                                card['tmin'], card['tmax'])
    want_any = ct.xla_cluster_trace(scene, card['o'], card['d'], 0.0,
                                    card['tmin'], card['any_tmax'], True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, 'rays.npz'), **rays)
        res = worker.launch(
            RANKS, ['--scene', 'alpha_leaf_standin', '--scene-kw',
                    json.dumps(dict(size=64)), '--tasks', 'ring', '--rays',
                    os.path.join(tmp, 'rays.npz'), '--repeat', 2],
            os.path.join(tmp, 'out.npz'), device='cuda', backend='gloo',
            timeout=RANK_TIMEOUT)
    stats = [s['ring'] for s in json.loads(str(res['stats']))]
    t, tri = res['ring/t'], res['ring/tri']
    t_w, tri_w = want.t.cpu().numpy(), want.tri.cpu().numpy()
    ties = tri != tri_w
    any_differ = int(((res['ring/any_tri'] >= 0)
                      != (want_any.tri.cpu().numpy() >= 0)).sum())
    phase('ring_alpha', ranks=RANKS, backend='gloo', n=RING_RAYS,
          launch_s=time.perf_counter() - t0, hits=int((tri_w >= 0).sum()),
          tri_ties=int(ties.sum()), max_abs_dt=float(np.abs(t - t_w).max()),
          any_hit_mismatch=any_differ,
          march_passes=[s['march_passes'] for s in stats],
          sweeps=[s['sweeps'] for s in stats],
          ring_rounds=[s['ring_rounds'] for s in stats],
          launches=[s['launches']['cluster_trace'] for s in stats],
          walls=[s['walls'] for s in stats],
          hop_ms_per_trace=[1e3 * s['hop_s'] / max(s['ring_traces'], 1)
                            for s in stats])
    assert np.array_equal(t, t_w), 'the alpha ring parts from one rank in t'
    assert ties.sum() <= RING_RAYS // 100 and any_differ == 0
    for s in stats:
        assert s['march_passes'] == 0, 'an alpha march ran under the ring'
        assert s['sweeps'] == s['ring_rounds'] > 0
        assert s['plain_calls'] == 0 and s['launches']['cluster_trace'] == 0


def edges_fd_cell(dev) -> None:
    """Phase 38: the edge gradients against finite differences on the card
    (diff/edge_fd: tests/test_edge_grad.py:73, 147, 219 and 284 at their
    sizes, samples and tolerances): each estimator, its finite difference
    and the relative error, held to the test's rule."""
    for name, check in edge_fd.CHECKS.items():
        t0 = time.perf_counter()
        r = check(dev)
        held = edge_fd.holds(r)
        phase('edges_fd', check=name, grad=r['grad'], fd=r['fd'],
              fds=r['fds'], rel_err=abs(r['grad'] - r['fd']) / abs(r['fd']),
              rtol=r['rtol'], blind=r['blind'], blind_max=r['blind_max'],
              held=held, wall_s=time.perf_counter() - t0)
        assert held, f'edges_fd {name}: the estimator parts from the fd'


def scaling_plumbing_cell() -> None:
    """Phase 39: `python -m raytracer_tpu_torch.scaling --backend gloo
    --ranks 1,2 --size 64` on the one card (cornell_pt from the tree): the
    module's lines, which must call themselves no scaling figure, since
    both ranks share the card."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, '-m', 'raytracer_tpu_torch.scaling', '--backend',
         'gloo', '--ranks', '1,2', '--size', '64'], capture_output=True,
        text=True, timeout=RANK_TIMEOUT, check=True,
        cwd=os.path.dirname(os.path.abspath(__file__))).stdout
    lines = [json.loads(x) for x in out.splitlines() if x.startswith('{')]
    phase('scaling', what='plumbing only: two gloo ranks share one card, '
          'no scaling figure', wall_s=time.perf_counter() - t0, lines=lines)
    assert [r.get('ranks') for r in lines[:2]] == [1, 2]
    assert [r['cards'] for r in lines[:2]] == [1, 1]
    assert lines[0]['note'] is None and 'no scaling figure' in lines[1]['note']
    assert not lines[2]['scaling_figure']


def remat_cell(dev, key) -> None:
    """Phase 40: RenderSettings.remat (each bounce step replayed in the
    backward pass, render/integrator._remat_step). bench.py's 1080p 1-spp
    step in one 2^21-ray tile, with remat off and on, the same key: each
    after a warm-up step, the median wall of 3, the peak memory, and the
    cluster kernel's launches in the forward pass and in the backward
    pass's replays (utils/counters.RECOMPUTE) apart, counted in the first
    timed step; the remat step against the plain one under phase 15's
    rule, at a lower peak. Then the 4-spp step in one 2^21-pixel tile
    (8,294,400 rays) with remat on: its wall, peak memory, a finite loss
    and nonzero grads."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=bench.TRAIN_TILE,
        device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    params = ts.get_params(scene)

    def step(remat, spp=1):
        return ts.loss_and_grads_scanned(
            params, scene, cam, dataclasses.replace(st, remat=remat),
            target, key, spp=spp, tile=bench.TRAIN_TILE)

    out = {}
    for remat in (False, True):
        tag = f'remat_{"on" if remat else "off"}_1080p'
        synced(lambda: step(remat))
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        walls = []
        for i in range(3):
            (loss, grads), wall = synced(lambda: step(remat))
            walls.append(wall)
            if i == 0:
                launches = check_only(ck, tag)
                replay = dict(counters.RECOMPUTE)
        loss, peak = float(loss), torch.cuda.max_memory_allocated()
        assert np.isfinite(loss), f'{tag}: non-finite loss'
        check_grads(grads, tag)
        out[remat] = loss, {k: g.cpu() for k, g in grads.items()}, peak
        del grads
        phase(tag, wall_s=walls, median_s=statistics.median(walls),
              peak_mem_gb=peak / 1e9, forward_launches=launches,
              recompute_launches=replay.get('launches.cluster_trace', 0),
              recomputed_steps=replay.get('steps', 0), loss=loss)
        assert (replay.get('steps', 0) > 0) == remat, f'{tag}: replays'
    rel, worst = grads_rule(*out[True][:2], *out[False][:2])
    phase('remat_parity', loss_rel_diff=rel, grad_excess_over_tol=worst,
          peak_ratio=out[True][2] / out[False][2])
    assert rel <= 1e-4 and max(worst.values()) <= 0.0, 'remat: grads differ'
    assert out[True][2] < out[False][2], 'remat: no lower peak'
    del out
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    (loss, grads), wall = synced(lambda: step(True, REMAT_SPP))
    launches = check_only(ck, 'remat_4spp_1080p')
    assert bool(torch.isfinite(loss)), 'remat 4 spp: non-finite loss'
    check_grads(grads, 'remat_4spp_1080p')
    phase('remat_4spp_1080p', spp=REMAT_SPP, tile_pixels=bench.TRAIN_TILE,
          rays=WIDTH * HEIGHT * REMAT_SPP, wall_s=wall,
          primary_rays_per_s=WIDTH * HEIGHT * REMAT_SPP / wall,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          forward_launches=launches,
          recompute_launches=counters.RECOMPUTE['launches.cluster_trace'],
          loss=float(loss))


def threefry_case(tag, kernel, plain, nbytes, ops):
    """One draw by the kernel and by the plain version on the same card:
    bit for bit, both CUDA-event times (median of 5; the kernel's over
    THREEFRY_REPS launches in a row, divided) and the draw's bytes and
    operations -> (ms, plain ms, Work)."""
    got = kernel()
    ms_k = cuda_ms(lambda: [kernel() for _ in range(THREEFRY_REPS)])[0] \
        / THREEFRY_REPS
    ms_p, want = cuda_ms(plain)
    got, want = (got,) if torch.is_tensor(got) else got, \
        (want,) if torch.is_tensor(want) else want
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, tag
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f'threefry {tag}: the kernel differs'
    work = Work()
    work.add(ops, nbytes)
    phase('threefry_kernel_vs_plain', case=tag, shape=list(got[0].shape),
          ms=ms_k, plain_ms=ms_p, equal=True, **work.bound(PEAK_INT_OPS))
    return ms_k, ms_p, work


def threefry_cell(dev, key) -> dict:
    """Phase 41: the threefry kernel on the main path, then against its
    plain version (core/rng.plain_*) at that path's shapes and in its
    other modes and layouts -> its record for the kernels line (ms,
    plain_ms and bound_ms over the three main-path draws, one each;
    launches in the driven step)."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=bench.TRAIN_TILE,
        device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    step = lambda: ts.loss_and_grads_scanned(
        ts.get_params(scene), scene, cam, st, target, key,
        tile=bench.TRAIN_TILE)
    synced(step)
    counters.reset()
    (loss, grads), wall = synced(step)
    check_only(ck, 'threefry_train_1080p')
    launches, modes = rk.LAUNCHES, dict(rk.MODES)
    assert launches > 0, 'the step drew without the threefry kernel'
    assert bool(torch.isfinite(loss)), 'threefry step: non-finite loss'
    check_grads(grads, 'threefry_train_1080p')
    phase('threefry_train_1080p', wall_s=wall, launches=launches,
          launches_by_mode=modes, cluster_launches=ck.LAUNCHES,
          loss=float(loss))
    del grads, scene
    R = WIDTH * HEIGHT
    k = rng.fold_in(key, 41)
    total = [0.0, 0.0, Work()]
    # the main path's draws: the bounce loop's, the lights', the camera's
    for tag, shape, axis in (('bounce', (R, 3), 0),
                             ('lights', (1, R, 2), 1),
                             ('camera', (R, 5), 0)):
        n = int(np.prod(shape))
        ms_k, ms_p, work = threefry_case(
            tag, lambda: rng.uniform_segmented(k, shape, None, axis, dev),
            lambda: rng.plain_uniform(k, shape, dev, None, axis),
            4 * n, THREEFRY_OPS['uniform'] * n)
        total[0] += ms_k
        total[1] += ms_p
        total[2].add(work.ops, work.nbytes)
    # the other modes and layouts, bit for bit (render_adaptive's segments
    # and per-pixel keys, the edge trainer's random_bits)
    for tag, shape, seg, axis in (('bounce_segmented', (R, 3), 1024, 0),
                                  ('lights_segmented', (1, R, 2), 1024, 1)):
        n = int(np.prod(shape))
        threefry_case(
            tag, lambda: rng.uniform_segmented(k, shape, seg, axis, dev),
            lambda: rng.plain_uniform(k, shape, dev, seg, axis),
            4 * n, THREEFRY_OPS['uniform'] * n)
    threefry_case('bits', lambda: rng.random_bits(k, (R,), dev),
                  lambda: rng.plain_bits(k, (R,), dev),
                  8 * R, THREEFRY_OPS['bits'] * R)
    ids = torch.arange(R, dtype=torch.int32, device=dev)
    words = lambda kk: (kk.k1, kk.k2)
    threefry_case('fold_in', lambda: words(rng.fold_in(k, ids)),
                  lambda: words(rng.plain_fold_in(k, ids)),
                  4 * R + 16 * R, (THREEFRY_OPS['bits'] - 1) * R)
    keys = rng.fold_in(k, ids[:R // 8])
    threefry_case('batch_keys', lambda: rng.uniform(keys, (5,)),
                  lambda: rng.plain_uniform(keys, (5,), dev),
                  16 * (R // 8) + 20 * (R // 8),
                  THREEFRY_OPS['uniform'] * 5 * (R // 8))
    return dict(name='threefry', route='cuda', source=THREEFRY_SOURCE,
                replaces=THREEFRY_REPLACES, launches=launches,
                max_abs_err=0.0, ms=total[0], plain_ms=total[1],
                **total[2].bound(PEAK_INT_OPS))


def take_case(tag, g, idx, shape) -> dict:
    """One take gradient (g, the output's gradient, for a table of `shape`
    read at idx) by the kernel and by index_add_ on the same card: the
    kernel within 1e-5 x the sum of |contributions| of the exact sum
    (float64) at each entry, and of index_add_'s within that and
    index_add_'s own error (the sums run in other orders, index_add_'s as
    one float32 atomic a contribution, in an order that changes from run
    to run: 2 M of them into one material row stray from the exact sum by
    more than 1e-5 of the magnitudes); CUDA-event times (median of 5) of
    the kernel (its wrapper, with the zeroed table), the plain version
    (scatter_rows' CPU branch: zeros, the index as int64, index_add_) and
    index_add_ alone (one torch.index_add into zeros made before); the
    bound, the bytes of the gradient, the index and the table written
    once over 3.35 TB/s."""
    rows = shape[0]
    K = idx.shape[-1] if idx.dim() >= 2 else 1
    C = math.prod(shape[1:])
    idx2 = idx.reshape(-1, K).contiguous()
    g3 = g.reshape(idx2.shape[0], K, C).contiguous()
    flat, g2 = idx.reshape(-1).long(), g3.reshape(-1, C)
    zeros = torch.zeros((rows, C), device=g.device)
    ms, got = cuda_ms(lambda: tk.scatter(g3, idx2, rows))
    plain_ms, want = cuda_ms(lambda: g.new_zeros((rows, C)).index_add_(
        0, idx.reshape(-1).long(), g2))
    library_ms, _ = cuda_ms(lambda: torch.index_add(zeros, 0, flat, g2))
    zeros64 = torch.zeros((rows, C), dtype=torch.float64, device=g.device)
    mag = zeros64.index_add(0, flat, g2.abs().double())
    exact = zeros64.index_add(0, flat, g2.double())
    err = (got.double() - want.double()).abs()
    err_exact = (got.double() - exact).abs()
    plain_err = (want.double() - exact).abs()
    excess = float((err_exact - 1e-5 * mag).max())
    excess_plain = float((err - 1e-5 * mag - plain_err).max())
    nbytes = 4 * g3.numel() + idx2.element_size() * idx2.numel() \
        + 4 * rows * C
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by='bytes',
               max_abs_err=float(err.max()))
    phase('take_scatter_vs_index_add', case=tag, table=list(shape),
          index=list(idx.shape), index_dtype=str(idx.dtype).split('.')[-1],
          mode=tk.mode(rows, C), excess_over_tol=excess,
          excess_over_tol_vs_index_add=excess_plain,
          max_err_vs_exact=float(err_exact.max()),
          index_add_max_err_vs_exact=float(plain_err.max()),
          excess_of_1e5_rule_vs_index_add=float((err - 1e-5 * mag).max()),
          **rec)
    assert excess <= 0.0 and excess_plain <= 0.0, \
        f'take-scatter {tag}: the kernel differs'
    return rec


def take_cell(dev, key) -> dict:
    """Phase 42: the take-scatter kernel on the main path, then against
    index_add_ at that path's shapes -> its record for the kernels line
    (ms, plain_ms, library_ms and bound_ms of one bounce's four take
    gradients: the corners twice, kd, spec_exp; launches in the driven
    step)."""
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=bench.TRAIN_TILE,
        device=dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    step = lambda: ts.loss_and_grads_scanned(
        ts.get_params(scene), scene, cam, st, target, key,
        tile=bench.TRAIN_TILE)
    synced(step)
    # the step's take gradients (of each table and index shape the last
    # the backward pass makes: the first bounce's, where every ray is
    # alive), its sort's permutation, and every index_add_ on the card
    seen, calls, perms, plain = {}, [0], [], [0]
    scatter_rows, permute = vm.scatter_rows, vm.permute
    index_add = torch.Tensor.index_add_

    def watched_scatter(g, idx, shape):
        calls[0] += 1
        sig = (tuple(shape), tuple(idx.shape), idx.dtype)
        seen[sig] = (g.detach().clone(), idx.clone())
        return scatter_rows(g, idx, shape)

    def watched_permute(x, perm, inv):
        if not perms and inv is not None and x.dim() == 2:
            perms.append((perm.clone(), inv.clone(), tuple(x.shape)))
        return permute(x, perm, inv)

    def watched_index_add(self, *args, **kw):
        plain[0] += self.is_cuda
        return index_add(self, *args, **kw)

    counters.reset()
    vm.scatter_rows, vm.permute = watched_scatter, watched_permute
    torch.Tensor.index_add_ = watched_index_add
    try:
        (loss, grads), wall = synced(step)
    finally:
        vm.scatter_rows, vm.permute = scatter_rows, permute
        torch.Tensor.index_add_ = index_add
    check_only(ck, 'take_train_1080p')
    launches, modes = tk.LAUNCHES, dict(tk.MODES)
    assert launches > 0 and launches == calls[0], \
        f'take gradients {calls[0]}, kernel launches {launches}'
    assert modes.get('table_shared') and modes.get('table_global'), modes
    assert plain[0] == 0, 'index_add_ ran on the card'
    assert bool(torch.isfinite(loss)), 'take step: non-finite loss'
    check_grads(grads, 'take_train_1080p')
    phase('take_train_1080p', wall_s=wall, launches=launches,
          launches_by_mode=modes, take_gradients=calls[0],
          index_add_on_card=plain[0], loss=float(loss))
    del grads
    geom, mats = scene.geom, scene.materials
    cases = {'corners': (geom.vertices, 2), 'kd': (mats.kd, 1),
             'spec_exp': (mats.spec_exp, 1)}
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    err = 0.0
    for tag, (table, times) in cases.items():
        (g, idx), = [v for (shape, _, _), v in seen.items()
                     if shape == tuple(table.shape)]
        rec = take_case(tag, g, idx, tuple(table.shape))
        for k in total:
            total[k] += times * rec[k]
        err = max(err, rec['max_abs_err'])
    del seen
    # the sort: its permutation through the kernel, then its backward (the
    # gather by the inverse permutation) against index_add_, exact
    perm, inv, shape = perms[0]
    g = torch.randn(shape, device=dev)
    take_case('sort_permutation', g, perm, shape)
    ms_inv, got = cuda_ms(lambda: torch.index_select(g, 0, inv))
    ms_add, want = cuda_ms(lambda: torch.zeros_like(g).index_add_(0, perm, g))
    assert torch.equal(got, want), 'the sort: the inverse gather differs'
    phase('sort_inverse_gather', shape=list(shape), ms=ms_inv,
          index_add_ms=ms_add, equal=True,
          bound_ms=(8 * shape[0] + 8 * math.prod(shape)) / PEAK_BYTES * 1e3)
    return dict(name='take_scatter', route='cuda', source=TAKE_SOURCE,
                replaces=TAKE_REPLACES, launches=launches, max_abs_err=err,
                bound_by='bytes', **total)


def check_image(img, shape) -> None:
    assert tuple(img.shape) == shape, img.shape
    assert bool(torch.isfinite(img).all()), 'non-finite pixels'
    assert float(img.min()) >= 0.0, 'negative radiance'
    assert float(img.mean()) > 0.0, 'black image'


def main(dev=None) -> int:
    # ---------------------------------------------------------- 1. device
    assert torch.cuda.is_available(), 'no CUDA device: this smoke run needs one'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dev or torch.device('cuda', 0)
    phase('device', name=torch.cuda.get_device_name(0), smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)

    # ----------------------------------------------------------- 2. build
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        jobs = {name: pool.submit(timed, fn) for name, fn in (
            ('cluster_trace_s', ck.build), ('iseg_trace_s', isk.build),
            ('icluster_trace_s', ick.build), ('mt_trace_s', mtk.build),
            ('bvh_trace_s', bvk.build), ('threefry_s', rk.build),
            ('take_scatter_s', tk.build), ('native_host_s', native.get_lib))}
        built = {name: job.result() for name, job in jobs.items()}
    phase('build', wall_s=time.perf_counter() - t0, **built)
    # registers, spills and shared memory of every kernel instantiation
    phase('ptxas', **{name: [line.strip() for line in
                             ck.build_log(name).splitlines()
                             if 'entry' in line or 'spill' in line
                             or 'Used' in line]
                      for name in ('cluster_trace', 'iseg_trace',
                                   'icluster_trace', 'mt_trace',
                                   'bvh_trace', 'threefry', 'take_scatter')})

    # ----------------------------------------------------------- 3. scene
    t0 = time.perf_counter()
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the host edge table (a lexsort), part of the build, timed alone
    t0 = time.perf_counter()
    edges = ed.build_edge_table(scene.geom.face_v.cpu().numpy())
    phase('scene', triangles=scene.num_tris,
          clusters=scene.clusters.num_clusters,
          table_mb=scene.clusters.nbytes / 1e6, ray_tile=st.ray_tile,
          build_s=build_s, edges=int(edges.vid.shape[0]),
          edge_table_s=time.perf_counter() - t0)
    assert scene.num_tris == 174_724

    # ------------------------------------------- 4. kernel against plain
    max_err, ms_k, ms_p, bnd = compare_kernel(scene, cam, dev)
    max_err = max(max_err, compare_full_wavefront(scene, cam, dev))
    records = [{
        'name': 'cluster_trace', 'route': 'cuda',
        'source': 'raytracer_tpu_torch/csrc/cluster_trace.cu',
        'replaces': 'raytracer_tpu/ops/pallas/cluster_kernel.py:293',
        'max_abs_err': max_err, 'ms': ms_k, 'plain_ms': ms_p, **bnd}]

    # ------------------------------------------------------ 5. full render
    key = rng.PRNGKey(KEY)
    records[0]['launches'], _, frame_auto = render_cell(
        scene, cam, st, key, ck, 'render_1080p')
    frame_auto = frame_auto.cpu()       # held by phases 22 and 23

    # ------------------------------------------------- 6. CPU/GPU parity
    scene_s, cam_s, st_s = registry.sponza_standin(**PARITY, device='cpu')
    check_parity(scene_s, cam_s, st_s, key, ck, dev, 'cpu_gpu_parity')

    # --------------------------------------------- 7. two-level instancing
    for make, n_inst, kernel, plain, name, replaces in INSTANCED:
        t0 = time.perf_counter()
        scene, cam, st = make(WIDTH, HEIGHT, device=dev)
        torch.cuda.synchronize()
        icl = scene.iclusters
        fields = dict(instances=icl.num_instances, segments=icl.num_entries,
                      prototype_clusters=icl.max_proto_clusters,
                      triangles=scene.num_tris, table_mb=icl.nbytes / 1e6)
        phase(f'scene_{name}', build_s=time.perf_counter() - t0, **fields)
        assert icl.num_instances == n_inst
        err, t_k, t_p, bnd = compare_instanced(
            scene, cam, getattr(kernel, name), getattr(plain, name), dev)
        if kernel is isk:
            err = max(err, compare_segment_band(scene, cam, dev))
        launches, _, _ = render_cell(scene, cam, st, key, kernel,
                                  f'render_1080p_{name}', **fields)
        records.append({'name': name, 'route': 'cuda',
                        'source': f'raytracer_tpu_torch/csrc/{name}.cu',
                        'replaces': replaces, 'launches': launches,
                        'max_abs_err': err, 'ms': t_k, 'plain_ms': t_p,
                        **bnd})
        del scene

    # ------------------------------------- 8. instanced CPU/GPU parity
    scene_s, cam_s, st_s = registry.instanced_teapots_standin(
        PARITY['width'], PARITY['height'], device='cpu')
    check_parity(scene_s, cam_s, st_s, key, isk, dev,
                 'cpu_gpu_parity_instanced')

    # ------------------ 9, 10. the final forest, with trees and without
    for n_trees in (200, 0):
        forest_cell(dev, key, records, n_trees)

    # ---------------------------------- 11. the forest's CPU/GPU parity
    scene_s, cam_s, st_s = registry.final_forest_standin(
        PARITY['width'], PARITY['height'], **FOREST_PARITY, device='cpu')
    assert st_s.max_wavefront_steps == 3
    check_parity(scene_s, cam_s, st_s, key, ick, dev,
                 'cpu_gpu_parity_final_forest')

    # ---------------------------- 12. the MT kernel against its plain version
    scene, cam, _ = registry.sponza_standin(n_spheres=MT_SPHERES, device=dev)
    err, t_k, t_p, bnd = compare_mt(scene, cam, dev)
    records.append(dict(name='mt_trace', route='cuda',
                        source='raytracer_tpu_torch/csrc/mt_trace.cu',
                        replaces=MT_REPLACES, max_abs_err=err, ms=t_k,
                        plain_ms=t_p, **bnd))

    # ------------------------- 13. the trainer at full width (bench.py's step)
    scene, cam, st = registry.sponza_standin(
        WIDTH, HEIGHT, max_bounces=BOUNCES, ray_tile=bench.TRAIN_TILE,
        device=dev)
    train_cell(scene, cam, st, key)
    del scene

    # ---------------------------------- 14. the 'pallas' path at 1080p
    records[-1]['launches'] = pallas_cell(dev, key)

    # ------------------------------ 15. the trainer's CPU/GPU parity
    for intersector in ('auto', 'pallas'):
        train_parity(intersector, key, dev)

    # ------------------------ 16-19. edge-sampled visibility gradients
    edges_cell(dev, key)
    shadow_edges_cell(dev, key)
    instanced_edges_cell(dev, key)
    edges_parity(key, dev)

    # --------------------------------------- 20. adaptive supersampling
    adaptive_cell(dev, key)

    # ---------------------------------------- 21. the procedural stone
    stone_cell(dev)

    # ------------------------------------------------- 22. the wide BVH
    scene, cam, st = bvh_cell(dev, key, records, frame_auto)

    # ------------------------------------ 23. the loaders at full size
    loaders_cell(dev, key, frame_auto)

    # ------------------------------------------------ 24. the CLI
    with tempfile.TemporaryDirectory() as tmp:
        cli_cell(tmp)
    _, report = profiling.render_with_stats(scene, cam, st, key, log=False)
    print(report.pretty(), flush=True)
    phase('render_with_stats', wall_s=report.wall_s,
          first_call_extra_s=report.compile_s,
          primary_rays_per_s=report.primary_rays_per_s, probe=report.probe)
    assert report.probe['ray_tri'] > 0
    del scene

    # ------------------ 25-28. several ranks: data-parallel, ring, NCCL
    ref = data_parallel_cell(dev, key)
    ring_cell(dev, key, ref)
    nccl_cell(ref)
    dryrun_cell()

    # ------ 29-32. the asset scenes, from the stand-in tree written to disk
    with tempfile.TemporaryDirectory() as tree:
        built = asset_build_cell(dev, tree)
        hd = built.pop('sponza_proxy')
        sponza_proxy_cell(*hd, key)
        flagship_cell(dev, *built.pop('final_forest'), key)
        grid_cell(*built.pop('instanced_grid'), key)
        asset_parity_cell(key, dev)

        # --- 33-36. the XLA cluster tracer ('cluster'), 'cluster_pallas'
        xla_rays_cell(hd[0], hd[1], dev)
        xla_frame_cell(*hd, key)
        cluster_pallas_cell(*hd, key)
        del hd
        xla_alpha_cell(dev, key)

        # ------- 37-39. the alpha ring, finite differences, the scaling
        ring_alpha_cell(dev)
        edges_fd_cell(dev)
        scaling_plumbing_cell()

    # --------------------------------------------------------- 40. remat
    remat_cell(dev, key)

    # ------------------------------------------------ 41. the threefry kernel
    records.append(threefry_cell(dev, key))

    # ------------------------------------------- 42. the take-scatter kernel
    records.append(take_cell(dev, key))

    print(json.dumps({'kernels': [
        {k: r[k] for k in ('name', 'route', 'source', 'replaces', 'launches',
                           'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                           'bound_by', 'library_ms')}
        for r in records]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
