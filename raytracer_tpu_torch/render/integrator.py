"""Wavefront path-tracing integrator.

Port of raytracer_tpu/render/integrator.py: a masked bounce loop in which
every live ray carries its throughput, Russian roulette splits the Blinn
diffuse and specular branches as the reference samples them
(src/Blinn.cpp:91-336), NEE samples the lights at every diffuse vertex and
one continuation ray (diffuse GI, reflection or refraction) is spawned per
step. The RNG keys, splits and draws are the JAX package's, so one key
renders the same image on both. The loop stops early once every ray has
terminated (the JAX package's lax.cond step skip); under 'ring', once
every ray of every rank has. With RenderSettings.remat, each step runs
under torch.utils.checkpoint and the backward pass recomputes it (the
JAX package's jax.checkpoint of its scan body; `_remat_step`).
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint

from ..core import rng
from ..core import vecmath as vm
from ..core.types import Scene, RenderSettings, MAT_LAMBERT
from ..core.vecmath import EPSILON, MIRO_TMAX
from ..ops import cluster_trace as ct
from ..ops import intersect as isect
from ..ops import ring_trace as ring
from ..ops.cuda import bvh_kernel as bvk
from ..ops.cuda import cluster_kernel as ck
from ..ops.cuda import icluster_kernel as ick
from ..ops.cuda import iseg_kernel as isk
from ..ops.cuda import mt_kernel as mtk
from ..shading import textures as tex
from ..shading import lights as lt
from ..utils import counters

IOR_STACK = 12  # the reference's IORList depth (src/Ray.h:151-178)
# None, or a list that radiance() adds into while it is set: entry i
# gains the radiance bounce step i added, summed over the rays ((3,)
# float64 on the rays' device). The benchmark's gate reads it to see every
# path depth (raytracer_tpu_torch/bench.py)
DEPTH_RADIANCE: list | None = None
KIND_PRIMARY, KIND_GI, KIND_REFLECT, KIND_REFRACT = 0, 1, 2, 3


_take = vm.take


def _bary(vals, c, a, b):
    """Barycentric blend of per-corner values (..., 3, k), in a fixed sum
    order (corner 0, then 1, then 2)."""
    return (vals[..., 0, :] * c[..., None] + vals[..., 1, :] * a[..., None]) \
        + vals[..., 2, :] * b[..., None]


def hit_attributes(scene: Scene, tri, inst, a, b):
    """Interpolated shading attributes at a hit (HitInfo::getAllInfos,
    src/Ray.cpp:5-49) -> (N, geoN, T, BT, u, v). Instance hits get their
    normals moved to world space by the inverse transpose; tangents
    deliberately not, as in the reference (src/Ray.cpp:27-31)."""
    g = scene.geom
    c = 1.0 - a - b
    fn = _take(g.face_n, tri).long()
    N = vm.normalize(_bary(g.normals[fn], c, a, b))
    p = _take(g.vertices, _take(g.face_v, tri), 'corners_geoN')  # (R,3,3)
    geoN = vm.normalize(vm.cross(p[..., 1, :] - p[..., 0, :],
                                 p[..., 2, :] - p[..., 0, :]))
    has_uv = _take(g.face_has_uv, tri)
    uvw = _bary(g.texcoords[_take(g.face_t, tri).long()], c, a, b)
    u = torch.where(has_uv, uvw[..., 0], a)
    v = torch.where(has_uv, uvw[..., 1], b)
    T = vm.normalize(_bary(g.tangents[fn], c, a, b))
    BT = vm.normalize(_bary(g.bitangents[fn], c, a, b))
    T = torch.where(has_uv[..., None], T, 0.0)
    BT = torch.where(has_uv[..., None], BT, 0.0)
    if not scene.single_level:
        mt = scene.instances.m_inv_t[inst.clamp(min=0).long()]   # (R,3,3)
        N = vm.normalize(vm.transform_vector(mt, N))
        geoN = vm.normalize(vm.transform_vector(mt, geoN))
    return N, geoN, T, BT, u, v


def _scene_env_deferred(scene: Scene, batch, d):
    """The primary-miss background (src/Scene.cpp:236-241) via a TexBatch
    -> thunk to call after batch.run()."""
    if scene.env_tex >= 0:
        u, v = tex.env_uv(d)
        tid = torch.full(u.shape, scene.env_tex, dtype=torch.int32,
                         device=u.device)
        i = batch.add(tid, u, v)
        return lambda: batch.get(i)[..., :3] * scene.env_exposure
    return lambda: scene.bg_color.expand(d.shape)


def _material_env_deferred(scene: Scene, batch, mat, d):
    """Material::getEnvironmentColor (src/Material.cpp:44-64) via a
    TexBatch: per-material env map, else scene env, else background."""
    base_f = _scene_env_deferred(scene, batch, d)
    if not scene.has_material_env:
        return base_f
    tid = scene.materials.tex_env[mat]
    u, v = tex.env_uv(d)
    i = batch.add(tid, u, v)

    def thunk():
        mat_env = batch.get(i)[..., :3] \
            * scene.materials.env_exposure[mat][..., None]
        return torch.where((tid >= 0)[..., None], mat_env, base_f())
    return thunk


def _ior_top(stack, sp):
    return torch.gather(stack, -1, sp[..., None].long())[..., 0]


def _ior_push(stack, sp, value):
    sp2 = torch.clamp(sp + 1, max=IOR_STACK - 1)
    onehot = torch.nn.functional.one_hot(sp2.long(), IOR_STACK).to(stack.dtype)
    return stack * (1.0 - onehot) + value[..., None] * onehot, sp2


def _sort_wavefront(state: dict, segment=None) -> dict:
    """Permute the wavefront so ray blocks stay coherent: a stable sort
    (as jnp.argsort) of `sort_key`. The permutation decides which RNG slot
    each ray draws from. The float state moves through vm.permute, whose
    backward gathers by the inverse permutation (made here, once a sort,
    when a gradient will need it), the rest through take."""
    perm = torch.argsort(sort_key(state, segment), stable=True)
    inv = None
    if torch.is_grad_enabled() and any(v.requires_grad
                                       for v in state.values()):
        inv = torch.empty_like(perm).scatter_(
            0, perm, torch.arange(perm.shape[0], device=perm.device))
    return {k: vm.permute(v, perm, inv) if v.is_floating_point()
            else _take(v, perm) for k, v in state.items()}


def sort_key(state: dict, segment=None) -> torch.Tensor:
    """Each ray's wavefront sort key: dead rays to the back, then direction
    octant, then a 12-bit Morton code of the origin in the live rays'
    bounding box. With `segment`, each run of that many rays is a
    wavefront of its own, sorted within its run by its own box. A ray's
    key does not depend on its slot."""
    o, d, alive = state['o'].detach(), state['d'].detach(), state['alive']
    octant = ((d[:, 0] > 0).to(torch.int32)
              | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    n = 1 if segment is None else o.shape[0] // segment
    live_o = torch.where(alive[:, None], o, torch.inf).reshape(n, -1, 3)
    lo = live_o.amin(dim=1, keepdim=True)
    hi = torch.where(alive[:, None], o, -torch.inf).reshape(n, -1, 3) \
        .amax(dim=1, keepdim=True)
    q = torch.clamp((o.reshape(n, -1, 3) - lo)
                    / torch.clamp(hi - lo, min=1e-6) * 15.0,
                    0.0, 15.0).to(torch.int32).reshape(-1, 3)
    morton = torch.zeros_like(q[:, 0])
    for bit in range(4):
        for ax in range(3):
            morton = morton | (((q[:, ax] >> bit) & 1) << (3 * bit + ax))
    key = ((~alive).to(torch.int32) << 20) | (octant << 12) | morton
    if segment is not None:
        # the run first: the sort stays within each run
        run = torch.arange(o.shape[0], device=o.device) // segment
        key = (run << 21) | key
    return key


def trace_fn(scene: Scene, settings: RenderSettings):
    """Select the intersector -> tracer(o, d, time, tmin, tmax, any_hit),
    routed as raytracer_tpu/render/integrator.py:252-376 routes it.

    'auto' and 'cluster_pallas' trace a single-level scene through
    scene.clusters with the cluster tracer (lerping the basis by ray time
    when the scene is motion-blurred), wrapped in the alpha march when
    the scene has alpha maps. 'auto' traces a two-level scene as
    'cluster2' does: shallow prototypes (at most 16 clusters) through the
    flat segment tracer, deep ones through the hierarchical instance
    tracer, plus the motion-blurred world partition (scene.mb_clusters)
    through the cluster tracer in `mb` mode, merged by nearest t. Scenes
    with alpha maps wrap that in the alpha march; an opaque
    motion-blurred partition is traced once outside it and bounds the
    march by its t. Each of these tracers is the CUDA kernel for CUDA
    tensors and its plain PyTorch version for CPU tensors; a table is one
    launch (the JAX package's VMEM chunks of `_mb_chunks` are not
    needed). 'cluster' is the JAX package's XLA tracer of single-level
    scenes (ops/cluster_trace.xla_cluster_trace, plain PyTorch on either
    device): near-ordered, alpha tested inside its sweep, no march.
    'cluster' and 'cluster_pallas' on a two-level scene, which carries no
    scene.clusters, raise and name 'cluster2'.
    'brute' is the brute-force oracle of single-level scenes, and
    'pallas' the brute-force Moller-Trumbore sweep (the JAX package's
    Pallas MT kernel; here mt_kernel.brute_trace: the CUDA kernel for
    CUDA tensors, its plain version for CPU ones), also single-level.
    'bvh' traces any scene built with bvh=True through its merged BVH
    (bvh_kernel.bvh_trace: csrc/bvh_trace.cu for CUDA tensors,
    ops/traverse.bvh_trace for CPU ones), motion blur and alpha maps
    inside the walk; 'auto' takes it for a two-level scene that has no
    cluster tables (a motion-blurred prototype), as the JAX package's
    'auto' takes 'bvh' off the TPU. 'ring' traces a single-level scene
    whose scene.clusters is this rank's shard (ops/ring_trace.RingTracer,
    as raytracer_tpu/render/integrator.py:365-371): every rank of the
    shard's mesh must trace alike, so radiance takes its host decisions
    through the tracer's `any_live`; for a table that is not a shard it
    raises."""
    mode = settings.intersector
    if mode == 'ring':
        return ring.RingTracer(scene)
    if mode in ('cluster', 'cluster_pallas') and not scene.single_level:
        raise ValueError(
            f"intersector {mode!r} traces scene.clusters, which a two-level "
            f"scene does not carry: trace it with 'cluster2' (or 'auto')")
    if mode == 'auto' and not scene.single_level \
            and scene.iclusters is None and scene.mb_clusters is None:
        mode = 'bvh'            # a motion-blurred prototype
    if mode == 'bvh':
        if scene.blas is None:
            raise ValueError(f'intersector {settings.intersector!r}: the '
                             f'scene carries no BVH to trace; build it '
                             f'with bvh=True')
        return lambda o, d, time, tmin, tmax, any_hit: bvk.bvh_trace(
            scene, o, d, time, tmin, tmax, any_hit)
    if mode in ('auto', 'cluster', 'cluster_pallas') and scene.single_level:
        if scene.clusters is None:
            raise ValueError('the scene carries no cluster table')
        if mode == 'cluster':
            return lambda o, d, time, tmin, tmax, any_hit: \
                ct.xla_cluster_trace(scene, o, d, time, tmin, tmax, any_hit)

        def base(o, d, time, tmin, tmax, any_hit):
            return ck.cluster_trace(scene, o, d, time, tmin, tmax, any_hit)
        if not scene.has_alpha_maps:
            return base
        return lambda o, d, time, tmin, tmax, any_hit: ct.alpha_aware_trace(
            scene, base, o, d, time, tmin, tmax, any_hit)
    if mode == 'brute' and scene.single_level:
        return lambda o, d, time, tmin, tmax, any_hit: \
            isect.brute_force_trace(scene, o, d, time, tmin, tmax, any_hit)
    if mode == 'pallas' and scene.single_level:
        return lambda o, d, time, tmin, tmax, any_hit: \
            mtk.brute_trace(scene, o, d, time, tmin, tmax, any_hit)
    if mode not in ('auto', 'cluster2') or scene.single_level:
        raise NotImplementedError(
            f"intersector {mode!r} on a "
            f"{'single' if scene.single_level else 'two'}-level scene: "
            f"'brute' and 'pallas' trace single-level scenes only, and "
            f"'cluster2' two-level ones only")

    icl = scene.iclusters
    if icl is None:
        inst_trace = None
    elif icl.max_proto_clusters <= 16:
        inst_trace = isk.iseg_trace
    else:
        inst_trace = ick.icluster_trace

    def trace_mb(o, d, time, tmin, tmax, any_hit, h):
        h2 = ck.cluster_trace(scene, o, d, time, tmin, tmax, any_hit,
                              table=scene.mb_clusters, mb=True)
        return h2 if h is None else ct.merge_hits(h, h2)

    def base(o, d, time, tmin, tmax, any_hit):
        h = None if inst_trace is None else inst_trace(
            scene, o, d, time, tmin, tmax, any_hit)
        if scene.mb_clusters is not None:
            h = trace_mb(o, d, time, tmin, tmax, any_hit, h)
        return h

    if not scene.has_alpha_maps:
        return base
    if scene.mb_clusters is None or scene.mb_has_alpha or inst_trace is None:
        return lambda o, d, time, tmin, tmax, any_hit: ct.alpha_aware_trace(
            scene, base, o, d, time, tmin, tmax, any_hit)

    def inst_only(o, d, time, tmin, tmax, any_hit):
        return inst_trace(scene, o, d, time, tmin, tmax, any_hit)

    def tracer(o, d, time, tmin, tmax, any_hit):
        # the opaque motion-blurred partition, traced once, bounds the
        # march: only instance hits nearer than it matter
        h_mb = trace_mb(o, d, time, tmin, tmax, any_hit, None)
        tmax2 = torch.minimum(isect.ray_inputs(o, time, tmin, tmax)[2],
                              h_mb.t)
        h = ct.alpha_aware_trace(scene, inst_only, o, d, time, tmin, tmax2,
                                 any_hit)
        return ct.merge_hits(h, h_mb)
    return tracer


def radiance(scene: Scene, settings: RenderSettings, o, d, time,
             base_key: rng.Key, kind0=KIND_PRIMARY, prev_mat0=0,
             gi_bounces0=0, segment=None):
    """Radiance of a wavefront of camera rays -> (R, 3); one sample per
    ray.

    kind0, prev_mat0 and gi_bounces0 (scalars or (R,) tensors) seed the
    wavefront mid-path: diff/edges.gi_edge_vertex_grad restarts a path at
    its first diffuse vertex as a GI ray of that vertex's material
    (kind0=KIND_GI, prev_mat0=the material, gi_bounces0=1), so its side
    radiances get the GI bounce's env gating and emitter handling. The
    defaults are a camera ray's.

    segment: the rays are R / segment wavefronts of `segment` rays laid end
    to end, each traced as radiance() would trace it alone with this key
    (its own random numbers and its own sort), which is what
    render_adaptive's chunks are. Not for scenes with alpha maps, whose
    march budgets its passes by the wavefront's size."""
    R = o.shape[0]
    if segment is not None and (R % segment or scene.has_alpha_maps):
        raise ValueError(f'segment {segment}: R = {R} must be a multiple, '
                         f'in a scene without alpha maps')
    dev = o.device
    f32 = o.dtype
    tracer = trace_fn(scene, settings)
    zi = torch.zeros(R, dtype=torch.int32, device=dev)

    def seed(x):
        return zi + torch.as_tensor(x, dtype=torch.int32, device=dev)
    ior_stack = torch.zeros((R, IOR_STACK), dtype=f32, device=dev)
    ior_stack[:, 0] = 1.0
    ior_stack[:, 1] += 1.001
    state = dict(
        o=o, d=d,
        tp=torch.ones((R, 3), dtype=f32, device=dev),
        L=torch.zeros((R, 3), dtype=f32, device=dev),
        alive=torch.ones(R, dtype=torch.bool, device=dev),
        kind=seed(kind0),
        bounces=zi,
        gi_bounces=seed(gi_bounces0),
        ior_stack=ior_stack,
        ior_sp=zi + 1,
        prev_mat=seed(prev_mat0),
        time=torch.as_tensor(time, dtype=f32, device=dev).expand(R).clone(),
        pix=torch.arange(R, dtype=torch.int32, device=dev),
    )

    # a ring's ranks stop together (ops/ring_trace.py)
    any_live = tracer.any_live if isinstance(tracer, ring.RingTracer) \
        else lambda flag: bool(flag.any())
    step = _remat_step if settings.remat and torch.is_grad_enabled() \
        else _step
    total = 0.0
    for step_idx in range(settings.max_wavefront_steps):
        if not any_live(state['alive']):
            break
        state = step(scene, settings, tracer, state, step_idx, base_key,
                     segment)
        if DEPTH_RADIANCE is not None:
            # a sum over the rays does not see the wavefront's sort
            now = state['L'].detach().double().sum(0)
            if step_idx < len(DEPTH_RADIANCE):
                DEPTH_RADIANCE[step_idx] = DEPTH_RADIANCE[step_idx] \
                    + (now - total)
            else:
                DEPTH_RADIANCE.append(now - total)
            total = now
    if settings.sort_rays:
        # scatter radiance back to the original ray order
        out = torch.zeros_like(state['L'])
        out[state['pix'].long()] = state['L']
        return out
    return state['L']


def _remat_step(scene: Scene, settings: RenderSettings, tracer, state,
                step_idx, base_key, segment=None):
    """_step under torch.utils.checkpoint (RenderSettings.remat, the JAX
    package's jax.checkpoint of its scan body): autograd keeps the step's
    incoming state and nothing of its inside, and the backward pass
    replays the step to get its intermediates back. The replay is the
    forward pass again, exactly:
      * random numbers come from the explicit threefry keys of core/rng
        (base_key, step_idx); nothing on the path draws from torch's
        global generators, so preserve_rng_state=False skips saving and
        restoring them for nothing;
      * the wavefront sort is a stable argsort of keys computed from the
        state, and each host decision inside the step (the alpha
        march's `(~done).any()`, the plain tracers' loops and masked
        selections) reads the same values; the determinism check stays
        on and refuses a replay whose intermediates change shape;
      * the state's tensors go in as the checkpoint's own inputs, so
        autograd's version counters refuse a backward pass after an
        in-place write to one of them (the step, the tracers and the
        march write only into tensors they made);
      * early stop is off: every replay runs the whole step, so each rank
        of a ring replays every collective of its step. The ranks' backward
        passes replay the same steps in the same order, as their graphs
        are alike.
    The replay runs inside utils/counters.recomputing: the launch, march,
    ring and collective counters keep the forward pass's counts, and
    counters.RECOMPUTE gets the replay's."""
    keys = tuple(state)
    replay = False

    def run(*tensors):
        nonlocal replay
        args = (scene, settings, tracer, dict(zip(keys, tensors)), step_idx,
                base_key, segment)
        if not replay:
            replay = True
            return _step(*args)
        counters.RECOMPUTE['steps'] += 1
        with counters.recomputing():
            return _step(*args)

    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(run, *state.values(),
                                     use_reentrant=False,
                                     preserve_rng_state=False)


def _step(scene: Scene, settings: RenderSettings, tracer, state, step_idx,
          base_key, segment=None):
    """One bounce of the whole wavefront (the JAX package's scan body), or
    of each of its segments (radiance's `segment`)."""
    R = state['o'].shape[0]
    dev = state['o'].device
    f32 = state['o'].dtype
    mats = scene.materials
    key = rng.fold_in(base_key, step_idx)
    k_rr, k_gl, k_gi, k_disp, k_l1, k_l2 = rng.split(key, 6)
    # rr1, rr2, disp; glossy; GI cosine
    rnd = rng.uniform_segmented(k_rr, (R, 3), segment, 0, dev)
    rnd_gl = rng.uniform_segmented(k_gl, (R, 2), segment, 0, dev)
    rnd_gi = rng.uniform_segmented(k_gi, (R, 2), segment, 0, dev)

    o, d, tp, L, alive = (state['o'], state['d'], state['tp'], state['L'],
                          state['alive'])
    kind = state['kind']
    time = state['time']
    # dead lanes trace with tmax < 0, which every tracer culls at once
    tmax_live = torch.where(alive, MIRO_TMAX, -1.0).to(f32)
    hit = tracer(o, d, time, EPSILON, tmax_live, False)
    found = hit.valid & alive
    t, a, b = isect.refine_hit(scene, o, d, time, hit)

    tri = torch.clamp(hit.tri, min=0)
    mat = _take(scene.geom.face_mat, tri).long()
    N, geoN, T, BT, u, v = hit_attributes(scene, tri, hit.inst, a, b)
    P = o + t[:, None] * d
    view = -d

    # all of this bounce's texture reads go through one pool gather
    mats_tex = (mats.tex_color[mat], mats.tex_normal[mat], mats.tex_spec[mat],
                mats.tex_reflect[mat], mats.tex_refract[mat])
    tc, tn, ts_, tr_, tf_ = mats_tex
    tb = tex.TexBatch(scene.textures)
    i_surf = [tb.add(tid, u, v) for tid in mats_tex]
    prev_mat = state['prev_mat'].long()
    env_mat_f = _material_env_deferred(scene, tb, prev_mat, d)
    env_scene_f = _scene_env_deferred(scene, tb, d)
    tb.run()

    # ---------------------------------------------------------- miss paths
    miss = alive & ~hit.valid
    env_mat = env_mat_f()
    env_scene = env_scene_f()
    gi_ok = mats.sample_env[prev_mat] & (scene.env_tex >= 0)
    env_out = torch.where((kind == KIND_PRIMARY)[:, None], env_scene, env_mat)
    add_env = miss & ((kind != KIND_GI) | gi_ok)
    L = L + torch.where(add_env[:, None], tp * env_out, 0.0)

    # ----------------------------------------------------------- hit shading
    kd = _take(mats.kd, mat, 'kd')
    ka = mats.ka[mat]
    ks = mats.ks[mat]
    le = mats.le[mat]
    spec_exp = _take(mats.spec_exp, mat, 'spec_exp')
    spec_amt = mats.spec_amt[mat]
    reflect_amt0 = mats.reflect_amt[mat]
    refract_amt0 = mats.refract_amt[mat]
    spec_gloss = mats.spec_gloss[mat]
    is_lambert = mats.kind[mat] == MAT_LAMBERT

    # texture modulation (src/Blinn.cpp:114-142)
    texcol = tb.get(i_surf[0])[..., :3]
    diffuse = torch.where((tc >= 0)[:, None], texcol, kd)
    texn = tb.get(i_surf[1])[..., :3]
    N_mapped = texn[:, 0:1] * T + texn[:, 1:2] * BT + texn[:, 2:3] * N
    N = torch.where((tn >= 0)[:, None], N_mapped, N)  # unnormalised, as ref
    texs = tb.get(i_surf[2])[..., :3].mean(-1)
    spec_amt = torch.where(ts_ >= 0, texs * spec_amt, spec_amt)
    texr = tb.get(i_surf[3])[..., :3].mean(-1)
    reflect_amt = torch.where(tr_ >= 0, texr * reflect_amt0, reflect_amt0)
    texf = tb.get(i_surf[4])[..., :3].mean(-1)
    refract_amt = torch.where(tf_ >= 0, texf * refract_amt0, refract_amt0)

    # normal disambiguation + backface flip (src/Blinn.cpp:144-155)
    v_dot_n = vm.dot(view, N)
    v_dot_geo = vm.dot(view, geoN)
    n_eq = v_dot_n * v_dot_geo >= 0.0
    the_n = torch.where(n_eq[:, None], N, geoN)
    v_dot = torch.where(n_eq, v_dot_n, v_dot_geo)
    flip = v_dot < 0.0
    v_dot = v_dot.abs()
    the_n = torch.where(flip[:, None], -the_n, the_n)
    # Lambert uses the raw interpolated normal (src/Lambert.cpp:30,45)
    the_n = torch.where(is_lambert[:, None], N, the_n)

    rvec = d + 2.0 * v_dot[:, None] * the_n
    # glossy reflections perturb rVec (src/Blinn.cpp:160-165)
    rand_d = vm.cosine_sample(the_n, rnd_gl[:, 0], rnd_gl[:, 1])
    rvec_gl = vm.normalize(spec_gloss[:, None] * rvec
                           + (1.0 - spec_gloss)[:, None] * rand_d)
    rvec = torch.where((spec_gloss < 1.0)[:, None], rvec_gl, rvec)

    # IOR bookkeeping (src/Blinn.cpp:167-185)
    ior_stack, ior_sp = state['ior_stack'], state['ior_sp']
    in_ior = _ior_top(ior_stack, ior_sp)
    mat_ior = mats.ior[mat]                                # (R,3)
    if scene.has_dispersion:
        dispersing = mats.disperse[mat] & (kind != KIND_REFRACT)
    else:
        dispersing = torch.zeros(R, dtype=torch.bool, device=dev)
    # non-dispersing backface: pop (leaving the medium)
    do_pop = (~dispersing) & flip & found & (~is_lambert)
    ior_sp = torch.where(do_pop, torch.clamp(ior_sp - 1, min=0), ior_sp)
    popped_ior = _ior_top(ior_stack, ior_sp)
    out_ior_scalar = torch.where(flip, popped_ior, mat_ior[:, 1])
    out_ior = torch.where(dispersing[:, None], mat_ior,
                          out_ior_scalar[:, None])

    # Fresnel (src/Blinn.cpp:187-193) on channel 0 of out_ior
    fres = vm.schlick_fresnel if settings.use_schlick else vm.fresnel
    has_spec = (reflect_amt0 > 0.0) | (refract_amt0 > 0.0)
    rs = torch.where(has_spec, fres(in_ior, out_ior[:, 0], v_dot), 0.0)
    ts = torch.where(has_spec, 1.0 - rs, 0.0)

    rr_weight = 1.0 - rs * reflect_amt - ts * refract_amt
    rr_weight = torch.where(is_lambert, 1.0, rr_weight)
    rr_recip = torch.where(rr_weight > 0.0, 1.0 / rr_weight, 1.0)
    rr_recip_s = torch.where(1.0 - rr_weight > 0.0, 1.0 / (1.0 - rr_weight),
                             1.0)
    diffuse_branch = found & (rnd[:, 0] <= rr_weight)
    spec_branch = found & ~diffuse_branch

    # unconditional per-hit terms: Le, and ka scaled by rrRecip
    L = L + torch.where(found[:, None], tp * (le + ka * rr_recip[:, None]),
                        0.0)

    # ------------------------------------------------ diffuse branch: NEE
    # shadow rays only for lanes whose terms survive
    # secondary (non-primary) rays draw one dome sample (src/DomeLight.cpp:89)
    lpw, specw3, lp_back = lt.sample_all_lights(
        scene, tracer, P, the_n, rvec, spec_exp, time, k_l1, False,
        settings, want_back=scene.has_translucency, active=diffuse_branch,
        secondary_mask=(kind != KIND_PRIMARY), segment=segment)

    w_d = (tp * rr_recip[:, None]) * diffuse_branch[:, None]
    spec_term = ks * spec_amt[:, None] * specw3
    spec_term = torch.where(is_lambert[:, None], 0.0, spec_term)
    L = L + w_d * (lpw * diffuse + spec_term)

    # translucency (src/Blinn.cpp:223-236) from the same light samples
    if scene.has_translucency:
        transl = mats.translucency[mat]
        L = L + w_d * transl[:, None] * lp_back * diffuse \
            * (transl > 0.01)[:, None]

    # ----------------------------------------- diffuse branch: GI bounce
    gi_b = state['gi_bounces']
    emitter = (mats.emitted_power[mat] > 0.0) | (le.sum(-1) > 0.0)
    if settings.path_trace:
        # emitter hit: the GI slot returns emittedPower*Le (src/Blinn.cpp:47-51)
        L = L + torch.where((diffuse_branch & emitter)[:, None],
                            w_d * mats.emitted_power[mat][:, None] * le, 0.0)
        can_gi = diffuse_branch & ~emitter & ~is_lambert \
            & (gi_b < settings.max_bounces - 1)
        # last GI bounce: direct light only, reusing the NEE samples
        last_gi = diffuse_branch & ~emitter & ~is_lambert \
            & (gi_b >= settings.max_bounces - 1)
        L = L + torch.where(last_gi[:, None], w_d * lpw * diffuse, 0.0)
        gi_dir = vm.cosine_sample(the_n, rnd_gi[:, 0], rnd_gi[:, 1])
    else:
        can_gi = torch.zeros(R, dtype=torch.bool, device=dev)
        gi_dir = d

    # --------------------------------------------------- specular branch
    bounces = state['bounces']
    can_bounce = bounces < settings.spec_bounce_cap
    refl_p = reflect_amt * rs
    take_refl = spec_branch & (rnd[:, 1] < refl_p)
    take_refr = spec_branch & ~take_refl & (refract_amt * ts > 0.0)

    # dispersion channel RR (1/3 prob, 3x mask weight)
    ch = torch.remainder(torch.floor(rnd[:, 2] * 3.0).to(torch.int32), 3)
    ch_mask = torch.nn.functional.one_hot(ch.long(), 3).to(f32) * 3.0
    disp_now = dispersing & take_refr
    out_ior_ch = torch.gather(out_ior, -1, ch[:, None].long())[:, 0]
    eta_nd = in_ior / out_ior[:, 0]
    eta_d = in_ior / out_ior_ch
    eta = torch.where(disp_now, eta_d, eta_nd)
    tvec = vm.refract(d, the_n, v_dot, eta)

    w_s = tp * (ks * rr_recip_s[:, None])
    w_s = torch.where(disp_now[:, None], w_s * ch_mask, w_s)

    # capped specular rays take the env color instead (src/Blinn.cpp:260-267)
    tb2 = tex.TexBatch(scene.textures)
    env_r_f = _material_env_deferred(scene, tb2, mat, rvec)
    env_t_f = _material_env_deferred(scene, tb2, mat, tvec)
    tb2.run()
    env_r = env_r_f()
    env_t = env_t_f()
    L = L + torch.where((take_refl & ~can_bounce)[:, None], w_s * env_r, 0.0)
    L = L + torch.where((take_refr & ~can_bounce)[:, None], w_s * env_t, 0.0)

    spawn_refl = take_refl & can_bounce
    spawn_refr = take_refr & can_bounce
    spawn_spec = spawn_refl | spawn_refr
    spawn = can_gi | spawn_spec

    # push the IOR entered by refraction (src/Blinn.cpp:285,311)
    push_val = torch.where(disp_now, out_ior_ch, out_ior[:, 0])
    new_stack, new_sp = _ior_push(ior_stack, ior_sp, push_val)
    ior_stack = torch.where(spawn_refr[:, None], new_stack, ior_stack)
    ior_sp = torch.where(spawn_refr, new_sp, ior_sp)

    new_d = torch.where(spawn_refl[:, None], rvec,
                        torch.where(spawn_refr[:, None], tvec, gi_dir))
    new_kind = torch.where(spawn_refl, KIND_REFLECT,
                           torch.where(spawn_refr, KIND_REFRACT, KIND_GI))
    new_tp = torch.where(spawn_spec[:, None], w_s,
                         tp * rr_recip[:, None] * diffuse)
    new_bounces = torch.where(spawn_spec, bounces + 1, bounces)
    new_gi = torch.where(can_gi, gi_b + 1, gi_b)

    state = dict(
        o=torch.where(spawn[:, None], P, o),
        d=torch.where(spawn[:, None], new_d, d),
        tp=torch.where(spawn[:, None], new_tp, tp),
        L=L,
        alive=alive & spawn,
        kind=torch.where(spawn, new_kind.to(torch.int32), kind),
        bounces=new_bounces,
        gi_bounces=new_gi,
        ior_stack=ior_stack,
        ior_sp=ior_sp,
        prev_mat=torch.where(found, mat.to(torch.int32), state['prev_mat']),
        time=time,
        pix=state['pix'],
    )
    if settings.sort_rays:
        state = _sort_wavefront(state, segment)
    return state
