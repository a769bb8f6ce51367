"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

They carry a JAX-package scene, camera and settings across to
raytracer_tpu_torch and back, make test rays with numpy from a seed, so
both packages see the very same inputs, and build the port's scenes on the
CPU (`cpu`; the port builds on the card by default). jax is imported only
by the helpers that need it, so tests/test_torch_cuda.py, which runs where
jax is absent, can use `cpu` too.
"""
from __future__ import annotations

import dataclasses
import operator

import numpy as np

from raytracer_tpu_torch import convert


def cpu(make, *args, **kw):
    """A scene builder's result built on the CPU: make(..., device='cpu'),
    for registry builders, registry.make and SceneBuilder.build alike."""
    return make(*args, device='cpu', **kw)


def scene_arrays(scene_j):
    """(arrays, static) of a JAX scene, keyed by dotted pytree paths."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(scene_j)[0]
    arrays = {'.'.join(k.name for k in path): np.asarray(v)
              for path, v in leaves}
    static = {}
    for k in convert.STATIC_FIELDS:
        owner, _, name = k.rpartition('.')
        obj = operator.attrgetter(owner)(scene_j) if owner else scene_j
        if obj is not None:          # tables a scene does not carry
            static[k] = getattr(obj, name)
    return arrays, static


def to_port(scene_j):
    """The JAX scene as a raytracer_tpu_torch Scene (on the CPU)."""
    return cpu(convert.scene_from_arrays, *scene_arrays(scene_j))


def jax_camera(cam):
    """A port Camera as a JAX Camera."""
    import jax.numpy as jnp
    from raytracer_tpu.core import types as JT

    return JT.Camera(**{f.name: jnp.asarray(getattr(cam, f.name).numpy())
                        for f in dataclasses.fields(cam)})


def jax_settings(settings, **overrides):
    """A port RenderSettings as the JAX package's RenderSettings."""
    from raytracer_tpu.core import types as JT

    kw = dataclasses.asdict(settings)
    kw.update(overrides)
    return JT.RenderSettings(**kw)


def random_rays(bb_min, bb_max, tri, R, seed):
    """Incoherent rays: origins scattered around the scene's box, aimed at
    random points inside it -> numpy (o, d, time, distance to that point)."""
    rs = np.random.default_rng(seed)
    real = np.asarray(tri)[:, 0] >= 0       # skip the padding rows
    lo = np.asarray(bb_min)[real].min(0)
    hi = np.asarray(bb_max)[real].max(0)
    ctr, ext = (lo + hi) / 2, (hi - lo).max()
    o = ctr + rs.normal(size=(R, 3)) * ext
    tgt = ctr + rs.uniform(-0.5, 0.5, (R, 3)) * ext
    d = tgt - o
    dist = np.linalg.norm(d, axis=-1)
    d /= dist[:, None]
    time = rs.uniform(size=R)
    f = lambda x: np.ascontiguousarray(x, np.float32)
    return f(o), f(d), f(time), f(dist)


def triangle_soup(T, R, seed, n_dup=64):
    """A random triangle soup with forced ties, and rays that mostly hit it
    -> numpy (o, d, p0, p1, p2, valid, tmin, tmax, dup).

    Triangles T - n_dup .. T - 1 repeat triangles 0 .. n_dup - 1 (exact
    ties, won by the lower id); every 9th triangle is a padding lane
    (valid 0). Each ray aims at a random point of a random triangle (half
    of them at a duplicated one) from 1-4 units away; every 4th ray starts
    its interval past its target (tmin = 1.5 distance), every 16th is dead
    (tmax = -1), the rest end at 3x the distance. dup marks the rays aimed
    at a duplicated triangle."""
    rs = np.random.default_rng(seed)
    c = rs.uniform(-2, 2, (T, 3))
    p0, p1, p2 = c, c + rs.normal(size=(T, 3)) * 0.5, \
        c + rs.normal(size=(T, 3)) * 0.5
    for p in (p0, p1, p2):
        p[T - n_dup:] = p[:n_dup]
    valid = np.ones(T, np.int32)
    valid[::9] = 0
    valid[T - n_dup:] = valid[:n_dup]
    dup = rs.uniform(size=R) < 0.5
    k = np.where(dup, rs.integers(0, n_dup, R), rs.integers(0, T, R))
    u, v = rs.uniform(size=R), rs.uniform(size=R)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    tgt = p0[k] + u[:, None] * (p1[k] - p0[k]) + v[:, None] * (p2[k] - p0[k])
    dirs = rs.normal(size=(R, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dist = rs.uniform(1, 4, R)
    o = tgt - dirs * dist[:, None]
    lane = np.arange(R)
    tmin = np.where(lane % 4 == 1, 1.5 * dist, 1e-3)
    tmax = np.where(lane % 16 == 3, -1.0, 3.0 * dist)
    f = lambda x: np.ascontiguousarray(x, np.float32)
    return (f(o), f(dirs), f(p0), f(p1), f(p2), valid, f(tmin), f(tmax),
            dup & (valid[k] > 0))
