"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

They carry a JAX-package scene, camera and settings across to
raytracer_tpu_torch and back, and make test rays with numpy from a seed,
so both packages see the very same inputs.
"""
from __future__ import annotations

import dataclasses
import operator

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.core import types as JT
from raytracer_tpu_torch import convert


def scene_arrays(scene_j):
    """(arrays, static) of a JAX scene, keyed by dotted pytree paths."""
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
    return convert.scene_from_arrays(*scene_arrays(scene_j))


def jax_camera(cam):
    """A port Camera as a JAX Camera."""
    return JT.Camera(**{f.name: jnp.asarray(getattr(cam, f.name).numpy())
                        for f in dataclasses.fields(cam)})


def jax_settings(settings, **overrides):
    """A port RenderSettings as the JAX package's RenderSettings."""
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
