"""The HDR dome light in the port against the JAX package, on the CPU.

* `_sample_cdf_rows` (the per-row binary search) returns the same offsets
  as the JAX one, as integers, and the same positions.
* `sample_dome_light` and the dome branch of `sample_all_lights`, with
  the same key, points, normals and tracer: the same draws (the key split
  and the (num_samples, R, 2) uniform flatten in jax.random's order), the
  same one-sample rule for secondary rays. Irradiance, specular and back
  terms agree to rtol 1e-4 (sin, cos, atan2, acos and pow come from other
  libraries, an ulp or two apart; the HDR sun spot multiplies that).
* A render of `dome_standin` against `raytracer_tpu.render` (tolerance as
  tests/test_torch_render.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.ops import intersect as jisect
from raytracer_tpu.render import renderer as jr
from raytracer_tpu.shading import lights as jlt
import raytracer_tpu_torch as rt
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.ops import intersect as tisect
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.shading import lights as tlt

from .test_torch_render import _assert_images_close
from .torch_port_util import cpu, jax_camera, jax_settings, to_port

R = 1024


@pytest.fixture(scope='module')
def dome():
    sj, cam, st = cpu(registry.dome_standin, 24, builder=rj.SceneBuilder())
    return sj, to_port(sj), cam, st


def test_sample_cdf_rows_matches_jax(dome):
    """Offsets equal as int32, positions to 1 ulp-ish, for u drawn over the
    rows of the dome's own v tables, the exact CDF values included."""
    sj, sp, _, _ = dome
    cdf = sp.dome.v_cdf
    rs = np.random.default_rng(1)
    rows = rs.integers(0, cdf.shape[0], R).astype(np.int32)
    u = rs.uniform(size=R).astype(np.float32)
    u[:64] = cdf.numpy()[rows[:64], rs.integers(0, cdf.shape[1], 64)]
    pos, off, du = tlt._sample_cdf_rows(cdf, torch.from_numpy(rows),
                                        torch.from_numpy(u))
    jpos, joff, jdu = jlt._sample_cdf_rows(jnp.asarray(cdf.numpy()),
                                           jnp.asarray(rows), jnp.asarray(u))
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=1e-6)


def _points(sp, seed):
    """Points on the ground and the sphere with their normals, reflected
    view vectors and exponents -> numpy arrays."""
    rs = np.random.default_rng(seed)
    n = R // 2
    ground = np.stack([rs.uniform(-4, 4, n), np.zeros(n),
                       rs.uniform(-4, 4, n)], -1)
    dirs = rs.normal(size=(R - n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:, 1] = np.abs(dirs[:, 1])
    sphere = np.asarray([0.0, 1.0, 0.0]) + dirs * 1.001
    P = np.concatenate([ground + [0, 1e-3, 0], sphere])
    N = np.concatenate([np.tile([[0.0, 1.0, 0.0]], (n, 1)), dirs])
    rvec = rs.normal(size=(R, 3))
    rvec /= np.linalg.norm(rvec, axis=-1, keepdims=True)
    exp = rs.uniform(1, 30, R)
    f = lambda x: np.asarray(x, np.float32)
    return f(P), f(N), f(rvec), f(exp)


@pytest.mark.parametrize('want_back', [False, True])
def test_sample_dome_light_matches_jax(dome, want_back):
    """Four samples per ray, one for the masked (secondary) rays, a
    brute-force shadow tracer on both sides."""
    sj, sp, _, _ = dome
    P, N, rvec, exp = _points(sp, 2)
    active = np.random.default_rng(3).uniform(size=R) < 0.9
    single = np.random.default_rng(4).uniform(size=R) < 0.3
    key = 77

    def jtrace(o, d, time, tmin, tmax, any_hit):
        return jisect.brute_force_trace(sj, o, d, time, tmin, tmax, any_hit)

    def ttrace(o, d, time, tmin, tmax, any_hit):
        return tisect.brute_force_trace(sp, o, d, time, tmin, tmax, any_hit)
    J = lambda x: jnp.asarray(x)
    T = torch.from_numpy
    want = jlt.sample_dome_light(sj, jtrace, J(P), J(N), J(rvec), J(exp),
                                 0.0, jax.random.PRNGKey(key), 4, 4,
                                 want_back, J(active), 0.0, J(single))
    got = tlt.sample_dome_light(sp, ttrace, T(P), T(N), T(rvec), T(exp),
                                0.0, rng.PRNGKey(key), 4, 4, want_back,
                                T(active), 0.0, T(single))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())
    assert got[0].numpy().mean() > 0
    assert (got[2].numpy().sum() > 0) == want_back


def test_sample_all_lights_dome_branch(dome):
    """The dome through sample_all_lights: the key split order and the
    secondary mask (one sample for non-primary rays)."""
    sj, sp, _, st = dome
    P, N, rvec, exp = _points(sp, 5)
    secondary = np.arange(R) % 3 == 0

    def jtrace(o, d, time, tmin, tmax, any_hit):
        return jisect.brute_force_trace(sj, o, d, time, tmin, tmax, any_hit)

    def ttrace(o, d, time, tmin, tmax, any_hit):
        return tisect.brute_force_trace(sp, o, d, time, tmin, tmax, any_hit)
    J = lambda x: jnp.asarray(x)
    T = torch.from_numpy
    want = jlt.sample_all_lights(sj, jtrace, J(P), J(N), J(rvec), J(exp), 0.0,
                                 jax.random.PRNGKey(9), False,
                                 jax_settings(st), True, None, J(secondary))
    got = tlt.sample_all_lights(sp, ttrace, T(P), T(N), T(rvec), T(exp), 0.0,
                                rng.PRNGKey(9), False, st, True, None,
                                T(secondary))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())
    # the mask changes the estimate of the secondary rays only
    full = tlt.sample_all_lights(sp, ttrace, T(P), T(N), T(rvec), T(exp),
                                 0.0, rng.PRNGKey(9), False, st, True)
    moved = (full[0] != got[0]).any(-1).numpy()
    assert moved[secondary].any() and not moved[~secondary].any()


def test_render_dome_standin_matches_jax(dome):
    sj, sp, cam, st = dome
    want = jr.render(sj, jax_camera(cam),
                     jax_settings(st, intersector='cluster_pallas'),
                     jax.random.PRNGKey(3))
    got = rt.render(sp, cam, st, rng.PRNGKey(3))
    _assert_images_close(got.numpy(), np.asarray(want))
