"""Port core math against the JAX package: vecmath, tone map, camera rays
and texture lookups, on the same numpy inputs.

Tolerance: rtol 1e-6 (atol 1e-6 near zero). Both sides compute in float32,
but rsqrt, sin, cos, pow, atan2 and arccos come from different libraries
and may differ in the last ulp or two. The tone maps are integer outputs
and must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core import vecmath as jvm
from raytracer_tpu.core.types import Camera as JCamera, TexturePack as JTex
from raytracer_tpu.render import camera as jcam
from raytracer_tpu.shading import textures as jtex
from raytracer_tpu_torch.core import vecmath as tvm
from raytracer_tpu_torch.core.types import Camera, TexturePack
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.shading import textures as ttex

from .torch_port_util import jax_camera

RS = np.random.default_rng(20240611)
N = 512


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)


def _vec(n=N):
    return RS.normal(size=(n, 3)).astype(np.float32)


def _unit(n=N):
    v = _vec(n)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _u(n=N, lo=0.0, hi=1.0):
    return RS.uniform(lo, hi, size=n).astype(np.float32)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize('name', ['normalize', 'build_onb', 'cosine_sample',
                                  'refract', 'fresnel', 'schlick_fresnel'])
def test_vecmath(name):
    n, d = _unit(), _unit()
    if name == 'normalize':
        v = _vec()
        v[:4] = 0.0
        _close(tvm.normalize(T(v)), jvm.normalize(J(v)))
    elif name == 'build_onb':
        for t, j in zip(tvm.build_onb(T(n)), jvm.build_onb(J(n))):
            _close(t, j)
    elif name == 'cosine_sample':
        e1, e2 = _u(), _u()
        _close(tvm.cosine_sample(T(n), T(e1), T(e2)),
               jvm.cosine_sample(J(n), J(e1), J(e2)))
    elif name == 'refract':
        vdn, eta = _u(), _u(lo=0.5, hi=1.6)
        _close(tvm.refract(T(d), T(n), T(vdn), T(eta)),
               jvm.refract(J(d), J(n), J(vdn), J(eta)))
    else:
        n1, n2, c = _u(lo=1.0, hi=2.5), _u(lo=1.0, hi=2.5), _u(lo=-0.2)
        _close(getattr(tvm, name)(T(n1), T(n2), T(c)),
               getattr(jvm, name)(J(n1), J(n2), J(c)))


def test_tone_maps():
    c = np.concatenate([_u(N, -0.5, 1.5), np.float32([0.0, 1.0, 1e-6])])
    c3 = c[:513 // 3 * 3].reshape(-1, 3)
    np.testing.assert_array_equal(tvm.tone_map_u8(T(c3)).numpy(),
                                  np.asarray(jvm.tone_map_u8(J(c3))))
    _close(tvm.linear_to_gamma_f(T(c)), jvm.linear_to_gamma_f(J(c)))


@pytest.mark.parametrize('aperture', [0.0, 0.15])
def test_eye_rays(aperture):
    cam = Camera.make(eye=(1.0, 2.0, 5.0), look_at=(0.0, 0.5, 0.0), fov=50.0,
                      aperture=aperture, focus_plane=4.0, shutter=0.5)
    W, H = 40, 30
    px = RS.integers(0, W, N).astype(np.float32)
    py = RS.integers(0, H, N).astype(np.float32)
    rands = RS.uniform(size=(N, 5)).astype(np.float32)
    got = tcam.eye_rays(cam, W, H, T(px), T(py), 0.0, 1.0, 0.0, 1.0, T(rands))
    want = jcam.eye_rays(jax_camera(cam), W, H, J(px), J(py), 0.0, 1.0, 0.0,
                         1.0, J(rands))
    for t, j in zip(got, want):
        _close(t, j)
    for t, j in zip(tcam.center_rays(cam, W, H),
                    jcam.center_rays(jax_camera(cam), W, H)):
        _close(t, j)


def test_texture_lookups():
    """A random 3-texture pool (gray, RGB, RGBA), fused and single lookups;
    and the empty pool's constant."""
    sizes = [(5, 7, 1), (4, 3, 3), (6, 6, 4)]
    data = np.concatenate([RS.uniform(size=h * w * c) for h, w, c in sizes])
    offs = np.cumsum([0] + [h * w * c for h, w, c in sizes[:-1]])
    cols = dict(data=data.astype(np.float32), offset=offs.astype(np.int32),
                width=np.int32([s[1] for s in sizes]),
                height=np.int32([s[0] for s in sizes]),
                channels=np.int32([s[2] for s in sizes]))
    tp_t = TexturePack(**{k: T(v) for k, v in cols.items()})
    tp_j = JTex(**{k: J(v) for k, v in cols.items()})
    tid = RS.integers(-1, 3, N).astype(np.int32)
    u, v = _u(N, -2.0, 2.0), _u(N, -2.0, 2.0)
    got = ttex.tex_lookup_batch(tp_t, [(T(tid), T(u), T(v)),
                                       (T(tid[::-1].copy()), T(v), T(u))])
    want = jtex.tex_lookup_batch(tp_j, [(J(tid), J(u), J(v)),
                                        (J(tid[::-1].copy()), J(v), J(u))])
    for t, j in zip(got, want):
        _close(t, j)
    d = _unit()
    _close(ttex.env_lookup(tp_t, T(np.full(N, 1, np.int32)), T(d)),
           jtex.env_lookup(tp_j, J(np.full(N, 1, np.int32)), J(d)))
    empty = TexturePack(data=torch.zeros(0), offset=torch.zeros(0, dtype=torch.int32),
                        width=torch.zeros(0, dtype=torch.int32),
                        height=torch.zeros(0, dtype=torch.int32),
                        channels=torch.zeros(0, dtype=torch.int32))
    rgba = ttex.tex_lookup(empty, T(tid), T(u), T(v)).numpy()
    np.testing.assert_array_equal(rgba, np.tile([0, 0, 0, 1], (N, 1)))
