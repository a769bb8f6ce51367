"""Direct light sampling: point and rectangle lights.

Port of raytracer_tpu/shading/lights.py (PointLight::sampleLight,
src/PointLight.cpp:8-82; RectangleLight::sampleLight,
src/RectangleLight.cpp:42-137), with the same deliberate deviations as the
JAX package (translucency reuses the front pass's shadow rays) and the same
RNG splits, so a key draws the same samples. Every sampler takes
`tracer(o, d, time, tmin, tmax, any_hit) -> Hit`. The dome light is not
ported yet (ROADMAP queue 1 #11).
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core import vecmath as vm
from ..core.types import Scene
from ..core.vecmath import EPSILON, MIRO_TMAX, INV_4PI


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
                       noise_cutoff: float = 0.0):
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
        e = rng.uniform(sub, (num_samples, R, 2), dev)
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


def sample_dome_light(*args, **kwargs):
    raise NotImplementedError('the dome light: ROADMAP queue 1 #11')


def sample_all_lights(scene: Scene, tracer, P, N, rvec, spec_exp, time, key,
                      secondary: bool, settings, want_back: bool = False,
                      active=None):
    """The per-hit light loop (src/Blinn.cpp:213-221) -> (lightPower,
    lightSpec, backPower), each (R, 3). The 1-sample rule for secondary
    rays is the dome light's only (src/DomeLight.cpp:89), so it waits for
    the dome (ROADMAP queue 1 #11)."""
    R = P.shape[0]
    z = torch.zeros((R, 3), dtype=P.dtype, device=P.device)
    total, spec, back = z, z, z
    segs = settings.shadow_segments
    if scene.point_lights.position.shape[0] > 0:
        p, s, b = sample_point_lights(scene, tracer, P, N, rvec, spec_exp,
                                      time, segs, want_back, active)
        total, spec, back = total + p, spec + s, back + b
    if scene.rect_lights.v1.shape[0] > 0:
        ns = 1 if secondary else scene.rect_lights.num_samples
        key, sub = rng.split(key)
        p, s, b = sample_rect_lights(scene, tracer, P, N, rvec, spec_exp,
                                     time, sub, ns, segs, want_back, active,
                                     settings.light_noise_cutoff)
        total, spec, back = total + p, spec + s, back + b
    return total, spec, back
