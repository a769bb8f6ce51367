"""Carry a JAX-package scene or camera across as numpy arrays.

A JAX `Scene` is a pytree; flattened, its leaves are keyed by dotted paths
such as 'geom.vertices' or 'clusters.p0', and its static fields (the
pytree_node=False flags) are named the same way. `scene_from_arrays` builds
this package's Scene from such a dict (the edge table of diff/edges.py
included), and `scene_to_arrays` is its inverse over the fields this
package keeps; `params_from_arrays` and `params_to_arrays` do the same for
the trainer's six parameter leaves (parallel/sharding.get_params). Scenes,
cameras and parameters land on `device`, the card unless the caller names
another. This module sees numpy arrays only, never a jax object. The
merged BVH (`blas`, its static `depth`), the instance table's BLAS roots
and `bvh_root` come across with the rest; `materials.kt`, which nothing
reads, is ignored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import types as T
from .geometry.clusters import Clusters, InstancedClusters

# flags of the JAX Scene that this package's Scene keeps
SCENE_FLAGS = ('env_tex', 'has_material_env', 'has_dispersion',
               'has_translucency', 'single_level', 'has_motion_blur',
               'has_alpha_maps', 'mb_has_alpha', 'bvh_root')
# the static fields of the two-level table and of the dome
ICLUSTER_STATIC = tuple(f'iclusters.{k}' for k in (
    'cluster_size', 'num_instances', 'num_entries', 'max_proto_clusters'))
DOME_STATIC = tuple(f'dome.{k}' for k in (
    'tex', 'cast_shadows', 'fast_shadows', 'num_samples'))
# every static (non-array) field of the JAX Scene that this module reads
STATIC_FIELDS = SCENE_FLAGS + (
    'point_lights.cast_shadows', 'point_lights.fast_shadows',
    'rect_lights.cast_shadows', 'rect_lights.fast_shadows',
    'rect_lights.num_samples', 'clusters.cluster_size',
    'mb_clusters.cluster_size', 'blas.depth') + ICLUSTER_STATIC \
    + DOME_STATIC

_GROUPS = {'geom': T.Geometry, 'materials': T.Materials,
           'textures': T.TexturePack, 'point_lights': T.PointLights,
           'rect_lights': T.RectLights}
# tables a scene may or may not carry
_OPTIONAL = {'dome': T.DomeLight, 'clusters': Clusters,
             'instances': T.Instances, 'iclusters': InstancedClusters,
             'mb_clusters': Clusters, 'edges': T.EdgeTable,
             'blas': T.BVHArrays}
_CAMERA_FIELDS = ('eye', 'view_dir', 'up', 'fov', 'focus_plane',
                  'aperture', 'shutter')


def _check_tables(arrays: dict, static: dict) -> None:
    tables = ('clusters.tri',) if static['single_level'] else (
        'iclusters.tri', 'mb_clusters.tri', 'blas.child')
    if not any(t in arrays for t in tables):
        raise ValueError(f'the scene carries no {tables[0].split(".")[0]} '
                         f'table')


def _group(cls, prefix: str, arrays: dict, static: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        name = f'{prefix}.{f.name}'
        if name in arrays:
            kw[f.name] = torch.from_numpy(np.array(arrays[name]))
        elif name in static:
            kw[f.name] = static[name]
    return cls(**kw)


def scene_from_arrays(arrays: dict[str, np.ndarray], static: dict,
                      device=T.CUDA) -> T.Scene:
    """A Scene on `device` from a JAX scene's leaves (dotted paths) and
    static fields (STATIC_FIELDS)."""
    dev = T.device_of(device)
    _check_tables(arrays, static)
    groups = {k: _group(cls, k, arrays, static) for k, cls in _GROUPS.items()}
    groups.update({k: _group(cls, k, arrays, static)
                   for k, cls in _OPTIONAL.items()
                   if any(a.startswith(k + '.') for a in arrays)})
    return T.Scene(
        **groups,
        env_exposure=torch.from_numpy(np.array(arrays['env_exposure'])),
        bg_color=torch.from_numpy(np.array(arrays['bg_color'])),
        **{k: static[k] for k in SCENE_FLAGS}).to(dev)


def scene_to_arrays(scene: T.Scene) -> tuple[dict, dict]:
    """(arrays, static) in the keys scene_from_arrays reads."""
    arrays, static = {}, {}
    for prefix in (*_GROUPS, *_OPTIONAL):
        obj = getattr(scene, prefix)
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                arrays[f'{prefix}.{f.name}'] = v.detach().cpu().numpy()
            elif v is not None:       # None: an edge table without pairs
                static[f'{prefix}.{f.name}'] = v
    arrays['env_exposure'] = scene.env_exposure.cpu().numpy()
    arrays['bg_color'] = scene.bg_color.cpu().numpy()
    static.update({k: getattr(scene, k) for k in SCENE_FLAGS})
    return arrays, static


def camera_from_arrays(arrays: dict[str, np.ndarray],
                       device=T.CUDA) -> T.Camera:
    """A Camera on `device` from a JAX Camera's leaves, keyed by field
    name."""
    dev = T.device_of(device)
    return T.Camera(**{k: torch.from_numpy(np.array(arrays[k], np.float32))
                       for k in _CAMERA_FIELDS}).to(dev)


# the trainer's parameter leaves (parallel/sharding.PARAM_KEYS)
PARAM_KEYS = ('vertices', 'kd', 'spec_exp', 'tex_data', 'point_power',
              'rect_power')


def params_from_arrays(params: dict[str, np.ndarray],
                       device=T.CUDA) -> dict[str, torch.Tensor]:
    """The JAX package's `get_params` dict (numpy arrays) as this package's
    float32 leaves on `device`."""
    dev = T.device_of(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
            for k in PARAM_KEYS}


def params_to_arrays(params: dict[str, torch.Tensor]) -> dict:
    """The inverse of params_from_arrays: numpy arrays on the host."""
    return {k: params[k].detach().cpu().numpy().copy() for k in PARAM_KEYS}
