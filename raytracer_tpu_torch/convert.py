"""Carry a JAX-package scene or camera across as numpy arrays.

A JAX `Scene` is a pytree; flattened, its leaves are keyed by dotted paths
such as 'geom.vertices' or 'clusters.p0', and its static fields (the
pytree_node=False flags) are named the same way. `scene_from_arrays` builds
this package's Scene from such a dict, and `scene_to_arrays` is its
inverse over the fields this package keeps. This module sees numpy arrays
only, never a jax object. Leaves this package does not read (the BVH,
instance, edge and motion-blur tables) are ignored; scene features it does
not render yet raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import types as T
from .geometry.clusters import Clusters

# flags of the JAX Scene that this package's Scene keeps
SCENE_FLAGS = ('env_tex', 'has_material_env', 'has_dispersion',
               'has_translucency')
# flags whose only supported value is implied here (a single-level, static
# scene without alpha maps)
IMPLIED_FLAGS = {'single_level': True, 'has_motion_blur': False,
                 'has_alpha_maps': False}
# every static (non-array) field of the JAX Scene that this module reads
STATIC_FIELDS = SCENE_FLAGS + tuple(IMPLIED_FLAGS) + (
    'point_lights.cast_shadows', 'point_lights.fast_shadows',
    'rect_lights.cast_shadows', 'rect_lights.fast_shadows',
    'rect_lights.num_samples', 'clusters.cluster_size')

_GROUPS = {'geom': T.Geometry, 'materials': T.Materials,
           'textures': T.TexturePack, 'point_lights': T.PointLights,
           'rect_lights': T.RectLights, 'clusters': Clusters}
_CAMERA_FIELDS = ('eye', 'view_dir', 'up', 'fov', 'focus_plane',
                  'aperture', 'shutter')


def _check_supported(arrays: dict, static: dict) -> None:
    if not static['single_level']:
        raise NotImplementedError('two-level instancing: ROADMAP queue 1 #12')
    if any(k.startswith('dome.') for k in arrays):
        raise NotImplementedError('the dome light: ROADMAP queue 1 #11')
    if static['has_motion_blur']:
        raise NotImplementedError('motion blur: ROADMAP queue 1 #11')
    if static['has_alpha_maps']:
        raise NotImplementedError('alpha maps: ROADMAP queue 1 #11')
    if 'clusters.tri' not in arrays:
        raise ValueError('the scene carries no cluster table')


def _group(cls, prefix: str, arrays: dict, static: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        name = f'{prefix}.{f.name}'
        if name in arrays:
            kw[f.name] = torch.from_numpy(np.array(arrays[name]))
        elif name in static:
            kw[f.name] = static[name]
    return cls(**kw)


def scene_from_arrays(arrays: dict[str, np.ndarray], static: dict) -> T.Scene:
    """A CPU Scene from a JAX scene's leaves (dotted paths) and static
    fields (STATIC_FIELDS)."""
    _check_supported(arrays, static)
    groups = {k: _group(cls, k, arrays, static) for k, cls in _GROUPS.items()}
    return T.Scene(
        geom=groups['geom'], materials=groups['materials'],
        textures=groups['textures'], point_lights=groups['point_lights'],
        rect_lights=groups['rect_lights'], clusters=groups['clusters'],
        env_exposure=torch.from_numpy(np.array(arrays['env_exposure'])),
        bg_color=torch.from_numpy(np.array(arrays['bg_color'])),
        **{k: static[k] for k in SCENE_FLAGS})


def scene_to_arrays(scene: T.Scene) -> tuple[dict, dict]:
    """(arrays, static) in the keys scene_from_arrays reads."""
    arrays, static = {}, {}
    for prefix in _GROUPS:
        obj = getattr(scene, prefix)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                arrays[f'{prefix}.{f.name}'] = v.detach().cpu().numpy()
            else:
                static[f'{prefix}.{f.name}'] = v
    arrays['env_exposure'] = scene.env_exposure.cpu().numpy()
    arrays['bg_color'] = scene.bg_color.cpu().numpy()
    static.update({k: getattr(scene, k) for k in SCENE_FLAGS})
    static.update(IMPLIED_FLAGS)
    return arrays, static


def camera_from_arrays(arrays: dict[str, np.ndarray]) -> T.Camera:
    """A CPU Camera from a JAX Camera's leaves, keyed by field name."""
    return T.Camera(**{k: torch.from_numpy(np.array(arrays[k], np.float32))
                       for k in _CAMERA_FIELDS})
