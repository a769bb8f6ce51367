"""Direct light sampling: point, rectangle and HDR dome lights.

Port of raytracer_tpu/shading/lights.py (PointLight::sampleLight,
src/PointLight.cpp:8-82; RectangleLight::sampleLight,
src/RectangleLight.cpp:42-137; DomeLight::sampleLight,
src/DomeLight.cpp:80-161, with 2-D CDF importance sampling), with the same
deliberate deviations as the JAX package (translucency reuses the front
pass's shadow rays; dome samples below the horizon add zero; the dome's
specular dot is clamped at 0) and the same RNG splits, so a key draws the
same samples. Secondary rays draw one dome sample
(RenderSettings.light_secondary_single, src/DomeLight.cpp:89). Every
sampler takes `tracer(o, d, time, tmin, tmax, any_hit) -> Hit`. With
`segment`, the rays are a batch of wavefronts of that many rays each, and
every wavefront draws the samples it would draw alone
(rng.uniform_segmented). With `rows`, the R rays given are the first R of
a wavefront of `rows` rays, and draw what they draw in it: a light's
samples are a (num_samples, rows, 2) draw, whose counters run over the
rows within each sample, so the R rays take its first R rows. (Their
shadow traces' alpha marches budget by the caller's
ops/cluster_trace.march_rows.)
"""
from __future__ import annotations

import math

import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.types import Scene
from ..core.vecmath import EPSILON, MIRO_TMAX, INV_4PI, part
from . import textures as tex


def _shadow_attenuation(scene: Scene, tracer, P, L, dist, time,
                        cast_shadows: bool, fast: bool, segments: int,
                        active=None):
    """Shadow visibility in [0, 1].

    fast: any-hit boolean (src/BVH.cpp:1340). Otherwise a march through
    transparent surfaces that multiplies each front-facing hit's refract
    amount (src/PointLight.cpp:49-70). Inactive rays trace with tmax < 0,
    which every tracer culls at once."""
    R = P.shape[0]
    if not cast_shadows:
        return torch.ones(R, dtype=P.dtype, device=P.device)
    if fast:
        dist_eff = torch.as_tensor(dist, dtype=P.dtype,
                                   device=P.device).expand(R)
        if active is not None:
            dist_eff = torch.where(active, dist_eff, -1.0)
        with part('trace'):
            hit = tracer(P, L, time, EPSILON, dist_eff, True)
        return torch.where(hit.valid, 0.0, 1.0)
    o = P
    atten = torch.ones(R, dtype=P.dtype, device=P.device)
    traversed = torch.zeros(R, dtype=P.dtype, device=P.device)
    live = torch.ones(R, dtype=torch.bool, device=P.device)
    if active is not None:
        live = live & active
    for _ in range(segments):
        tmax_seg = torch.where(live, MIRO_TMAX, -1.0).to(P.dtype)
        with part('trace'):
            hit = tracer(o, L, time, EPSILON, tmax_seg, False)
        t, a, b = hit.t, hit.a, hit.b
        seg_live = live & hit.valid & (traversed + t < dist)
        tri = torch.clamp(hit.tri, min=0).long()
        fn = scene.geom.face_n[tri].long()
        c = 1.0 - a - b
        nrm = scene.geom.normals
        n = (nrm[fn[:, 0]] * c[:, None] + nrm[fn[:, 1]] * a[:, None]
             + nrm[fn[:, 2]] * b[:, None])
        n = vm.normalize(n)
        ndl = vm.dot(n, -L)
        mat = scene.geom.face_mat[tri].long()
        ra = scene.materials.refract_amt[mat]
        atten = torch.where(seg_live & (ndl > 0.0), atten * ra, atten)
        o = torch.where(seg_live[:, None], o + t[:, None] * L, o)
        traversed = torch.where(seg_live, traversed + t, traversed)
        live = seg_live & (atten > EPSILON)
    return atten


def _spec_pow(spec, spec_exp):
    """pow(spec, exp) with the base clamped away from 0 (a finite d/dexp)."""
    return torch.pow(torch.clamp(spec, min=1e-12), spec_exp)


def sample_point_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time,
                        segments: int = 4, want_back: bool = False,
                        active=None):
    """Sum over point lights -> (irradiance, spec, back), each (R, 3)."""
    R = P.shape[0]
    z = torch.zeros((R, 3), dtype=P.dtype, device=P.device)
    power_sum, spec_sum, back_sum = z, z, z
    pl = scene.point_lights
    for i in range(pl.position.shape[0]):
        L = pl.position[i] - P
        d2 = vm.length2(L)
        dist = torch.sqrt(d2)
        Lhat = L / dist[:, None]
        ndl = vm.dot(N, Lhat)
        atten0 = _shadow_attenuation(
            scene, tracer, P, Lhat, dist, time,
            pl.cast_shadows[i], pl.fast_shadows[i], segments, active)
        atten = torch.where(ndl > 0.0, atten0 * ndl, 0.0)
        E_base = (pl.power[i] * pl.color[i])[None, :] \
            * (INV_4PI / d2)[:, None]
        E = E_base * atten[:, None]
        power_sum = power_sum + E
        spec_i = torch.clamp(vm.dot(rvec, Lhat), min=0.0) * atten
        spec_sum = spec_sum + E * _spec_pow(spec_i, spec_exp)[:, None]
        if want_back:
            atten_b = torch.where(-ndl > 0.0, atten0 * -ndl, 0.0)
            back_sum = back_sum + E_base * atten_b[:, None]
    return power_sum, spec_sum, back_sum


def _rect_area_power(v1, v2, v3, power):
    """Area-normalised wattage (src/RectangleLight.cpp:14-40)."""
    e0 = v2 - v1
    e1 = v3 - v1
    rect_like = vm.dot(e0, e1).abs() < EPSILON
    area_sq = torch.where(rect_like, vm.length2(e0) * vm.length2(e1),
                          vm.length2(vm.cross(e0, e1)))
    recip = torch.where(area_sq > EPSILON, torch.rsqrt(area_sq),
                        torch.ones_like(area_sq))
    return power * recip


def sample_rect_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                       num_samples: int, segments: int = 4,
                       want_back: bool = False, active=None,
                       noise_cutoff: float = 0.0, segment=None, rows=None):
    """Sum over rectangle lights -> (irradiance, spec, back); spec applies
    pow once per light to the sample-averaged spec dot
    (src/RectangleLight.cpp:135-136)."""
    R = P.shape[0]
    dev, dt = P.device, P.dtype
    z = torch.zeros((R, 3), dtype=dt, device=dev)
    power_sum, spec_sum, back_sum = z, z, z
    rl = scene.rect_lights
    for i in range(rl.v1.shape[0]):
        p_eff = _rect_area_power(rl.v1[i], rl.v2[i], rl.v3[i], rl.power[i])
        key, sub = rng.split(key)
        e = _draw_samples(sub, num_samples, R, rows, segment, dev)
        acc = z
        acc_s = torch.zeros(R, dtype=dt, device=dev)
        acc_b = z
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        n_done = torch.zeros(R, dtype=dt, device=dev)
        for s in range(num_samples):
            live = ~done
            e1 = e[s, :, 0]
            e2 = torch.clamp(e[s, :, 1], max=0.99)  # src/RectangleLight.cpp:58
            pt = rl.v1[i] + e1[:, None] * (rl.v2[i] - rl.v1[i]) \
                + e2[:, None] * (rl.v3[i] - rl.v1[i])
            L = pt - P
            d2 = vm.length2(L)
            dist = torch.sqrt(d2)
            Lhat = L / dist[:, None]
            ndl_raw = vm.dot(N, L)
            # fast shadows stop EPSILON short (src/RectangleLight.cpp:84)
            sh_dist = dist - EPSILON if rl.fast_shadows[i] else dist
            act = live if active is None else (active & live)
            atten0 = _shadow_attenuation(
                scene, tracer, P, Lhat, sh_dist, time,
                rl.cast_shadows[i], rl.fast_shadows[i], segments, act)
            atten = torch.where(ndl_raw > EPSILON, atten0, 0.0)
            # no cosine term, as the reference (src/RectangleLight.cpp:124-131)
            E = (p_eff * rl.color[i])[None, :] * (INV_4PI / d2)[:, None]
            acc = acc + torch.where(live[:, None], E * atten[:, None], 0.0)
            acc_s = acc_s + torch.where(
                live, torch.clamp(vm.dot(rvec, Lhat), min=0.0) * atten, 0.0)
            if want_back:
                atten_b = torch.where(-ndl_raw > EPSILON, atten0, 0.0)
                acc_b = acc_b + torch.where(live[:, None],
                                            E * atten_b[:, None], 0.0)
            n_done = n_done + live
            if s + 1 < num_samples and noise_cutoff > 0.0:
                cut = E.mean(dim=-1) / n_done < noise_cutoff
                done = done | (live & cut)
        recip = 1.0 / torch.clamp(n_done, min=1.0)
        E_mean = acc * recip[:, None]
        power_sum = power_sum + E_mean
        spec_sum = spec_sum \
            + E_mean * _spec_pow(acc_s * recip, spec_exp)[:, None]
        back_sum = back_sum + acc_b * recip[:, None]
    return power_sum, spec_sum, back_sum


def _draw_samples(key, num_samples: int, R: int, rows, segment, dev):
    """A light's (num_samples, R, 2) uniforms: the first R rows of each
    sample's draw over `rows` rays (default R)."""
    rows = R if rows is None else rows
    e = rng.uniform_segmented(key, (num_samples, rows, 2), segment, 1, dev)
    return e if rows == R else e[:, :R]


def _sample_cdf_rows(cdf2, rows, u):
    """Distribution1D::sample (src/DomeLight.h:31-38) over per-ray rows.

    cdf2: (K, n + 1) row CDFs; rows, u: (R,). -> (pos, offset, du), with
    offset the count of row entries strictly below u, less one and
    clamped to [0, n - 1], found by a binary search of ceil(log2(n + 2))
    pointwise gathers in int32 (lights.py:238-265 of the JAX package)."""
    n = cdf2.shape[-1] - 1
    rows = rows.long()
    lo = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    hi = torch.full(u.shape, n + 1, dtype=torch.int32, device=u.device)
    for _ in range(int(math.ceil(math.log2(n + 2)))):
        mid = (lo + hi) // 2
        less = cdf2[rows, mid.clamp(0, n).long()] < u
        lo = torch.where(less, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(less, hi, mid)
    offset = (lo - 1).clamp(0, n - 1)
    c0 = cdf2[rows, offset.long()]
    c1 = cdf2[rows, offset.long() + 1]
    du = (u - c0) / torch.clamp(c1 - c0, min=1e-20)
    return offset.to(torch.float32) + du, offset, du


def _sample_cdf(cdf, u):
    """One shared CDF row (the u marginal): cdf (n + 1,), u (R,)."""
    rows = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    return _sample_cdf_rows(cdf[None, :], rows, u)


def sample_dome_light(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                      num_samples: int, segments: int = 4,
                      want_back: bool = False, active=None,
                      noise_cutoff: float = 0.0, single_mask=None,
                      segment=None, rows=None):
    """HDR dome importance sampling -> (irradiance, spec, back), each
    (R, 3) (src/DomeLight.cpp:80-161): u from the marginal CDF, v from its
    column's CDF, the direction from the table angles at floor indices,
    pdf = pu pv / (2 pi^2 sin theta); shadow rays reach MIRO_TMAX. Rays in
    single_mask stop after one sample; the mean divides by the samples each
    ray drew."""
    dome = scene.dome
    R = P.shape[0]
    dev, dt = P.device, P.dtype
    z = torch.zeros((R, 3), dtype=dt, device=dev)
    if dome is None:
        return z, z, z
    nu = dome.u_func.shape[0]
    nv = dome.v_func.shape[1]
    key, sub = rng.split(key)
    e = _draw_samples(sub, num_samples, R, rows, segment, dev)
    tex_id = torch.full((R,), dome.tex, dtype=torch.int32, device=dev)
    acc, acc_b = z, z
    acc_s = torch.zeros(R, dtype=dt, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    n_done = torch.zeros(R, dtype=dt, device=dev)
    for s in range(num_samples):
        live = ~done
        fu, uo, _ = _sample_cdf(dome.u_cdf, e[s, :, 0])
        pdf_u = dome.u_func[uo.long()] / dome.u_func_int
        ucol = fu.to(torch.int32).clamp(0, nu - 1)
        fv, vo, _ = _sample_cdf_rows(dome.v_cdf, ucol, e[s, :, 1])
        pdf_v = dome.v_func[ucol.long(), vo.long()] \
            / torch.clamp(dome.v_func_int[ucol.long()], min=1e-20)
        # table angles at floor indices (src/DomeLight.cpp:102-103)
        theta = torch.floor(fv) * (vm.PI / nv)
        phi = torch.floor(fu) * (2.0 * vm.PI / nu)
        sin_t = torch.sin(theta)
        direction = torch.stack([-sin_t * torch.cos(phi), -torch.cos(theta),
                                 -sin_t * torch.sin(phi)], dim=-1)
        ndl = vm.dot(N, direction)
        pdf = (pdf_u * pdf_v) / (vm.TWO_PI_SQ * torch.clamp(sin_t, min=1e-8))
        radiance = tex.env_lookup(scene.textures, tex_id, direction)
        act = live if active is None else (active & live)
        atten0 = _shadow_attenuation(
            scene, tracer, P, direction, MIRO_TMAX, time,
            dome.cast_shadows, dome.fast_shadows, segments, act)
        atten = torch.where(ndl >= 0.0, atten0, 0.0)
        E = dome.gain * radiance / torch.clamp(pdf, min=1e-20)[:, None]
        acc = acc + torch.where(live[:, None], E * atten[:, None], 0.0)
        acc_s = acc_s + torch.where(
            live, torch.clamp(vm.dot(rvec, direction), min=0.0) * atten, 0.0)
        if want_back:
            atten_b = torch.where(-ndl >= 0.0, atten0, 0.0)
            acc_b = acc_b + torch.where(live[:, None], E * atten_b[:, None],
                                        0.0)
        n_done = n_done + live
        if s + 1 < num_samples:
            if noise_cutoff > 0.0:
                cut = E.mean(dim=-1) / n_done < noise_cutoff
                done = done | (live & cut)
            if single_mask is not None:
                done = done | single_mask
    recip = 1.0 / torch.clamp(n_done, min=1.0)
    E_mean = acc * recip[:, None]
    spec3 = E_mean * _spec_pow(acc_s * recip, spec_exp)[:, None]
    return E_mean, spec3, acc_b * recip[:, None]


def sample_all_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                      secondary: bool, settings, want_back: bool = False,
                      active=None, secondary_mask=None, segment=None,
                      rows=None):
    """The per-hit light loop (src/Blinn.cpp:213-221) -> (lightPower,
    lightSpec, backPower), each (R, 3). secondary_mask (R,) marks the rays
    that draw one dome sample (src/DomeLight.cpp:89; rect lights ignore
    it, as in the reference)."""
    R = P.shape[0]
    z = torch.zeros((R, 3), dtype=P.dtype, device=P.device)
    total, spec, back = z, z, z
    segs = settings.shadow_segments
    if scene.point_lights.position.shape[0] > 0:
        with part('point'):
            p, s, b = sample_point_lights(scene, tracer, P, N, rvec,
                                          spec_exp, time, segs, want_back,
                                          active)
            total, spec, back = total + p, spec + s, back + b
    if scene.rect_lights.v1.shape[0] > 0:
        ns = 1 if secondary else scene.rect_lights.num_samples
        key, sub = rng.split(key)
        with part('rect'):
            p, s, b = sample_rect_lights(scene, tracer, P, N, rvec, spec_exp,
                                         time, sub, ns, segs, want_back,
                                         active, settings.light_noise_cutoff,
                                         segment, rows)
            total, spec, back = total + p, spec + s, back + b
    if scene.dome is not None:
        if not settings.light_secondary_single:
            secondary_mask = None
        ns = 1 if secondary else scene.dome.num_samples
        key, sub = rng.split(key)
        with part('dome'):
            p, s, b = sample_dome_light(scene, tracer, P, N, rvec, spec_exp,
                                        time, sub, ns, segs, want_back,
                                        active, settings.light_noise_cutoff,
                                        secondary_mask, segment, rows)
            total, spec, back = total + p, spec + s, back + b
    return total, spec, back
