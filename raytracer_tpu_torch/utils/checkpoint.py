"""Checkpoint / resume for progressive renders and inverse-rendering runs.

Port of raytracer_tpu/utils/checkpoint.py, in its file layout: an .npz
holding `magic` (the bytes of _MAGIC), `__treedef__` (a description of the
tree), the leaves as `leaf_{i}` and named scalars as `scalar_{k}`, written
to a temporary file and moved into place with `os.replace`, so a crash
mid-save never corrupts the previous checkpoint. The two packages read
each other's files.

A tree is flattened in a fixed order, the JAX package's for the same
structure: a dict's values by sorted key, a tuple's or list's in order,
recursively; None holds no leaf; anything else (a tensor, an array, a
number) is one leaf. Leaves load as tensors on the device of the matching
leaf of the tree they are loaded like (numpy arrays where that leaf is not
a tensor).

A render is a sum of independent spp batches, so the accumulated radiance
plus the batch cursor is the resumable state; an optimization is (params,
optimizer state, step).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..core import rng
from ..core.types import Camera, RenderSettings, Scene
from . import console

_MAGIC = 'raytracer_tpu-ckpt-v1'


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _describe(tree) -> str:
    if tree is None:
        return 'None'
    if isinstance(tree, dict):
        return '{' + ', '.join(f'{k!r}: {_describe(tree[k])}'
                               for k in sorted(tree)) + '}'
    if isinstance(tree, (tuple, list)):
        return '(' + ', '.join(_describe(v) for v in tree) + ')'
    return '*'


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in flattening order, from the
    iterator `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    value = next(leaves)
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(value, device=tree.device)
    return value


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _read(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    magic = bytes(flat.get('magic', b'')).decode(errors='replace')
    if magic != _MAGIC:
        raise ValueError(f'{path}: not a raytracer_tpu checkpoint')
    return flat


def save_state(path: str, tree, **scalars) -> None:
    """Atomically save a tree of tensors or arrays and named scalars to
    `path` (.npz)."""
    payload = {'__treedef__': np.frombuffer(_describe(tree).encode(),
                                            dtype=np.uint8)}
    for i, leaf in enumerate(_leaves(tree)):
        payload[f'leaf_{i}'] = _host(leaf)
    for k, v in scalars.items():
        payload[f'scalar_{k}'] = np.asarray(v)
    payload['magic'] = np.frombuffer(_MAGIC.encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, like_tree):
    """Load (tree, scalars) saved by save_state; the tree has
    `like_tree`'s structure. Returns None if the file does not exist."""
    if not os.path.exists(path):
        return None
    flat = _read(path)
    n = len(_leaves(like_tree))
    tree = _rebuild(like_tree, iter(flat[f'leaf_{i}'] for i in range(n)))
    scalars = {k[len('scalar_'):]: flat[k] for k in flat
               if k.startswith('scalar_')}
    return tree, scalars


def render_progressive(scene: Scene, cam: Camera, settings: RenderSettings,
                       key: rng.Key, spp_total: int, spp_batch: int = 1,
                       ckpt_path: str | None = None, save_every: int = 1,
                       log: bool = False, on_batch=None) -> torch.Tensor:
    """Render spp_total samples in batches, checkpointing between batches.

    Resumable: if `ckpt_path` exists, accumulation continues from the saved
    batch cursor, and the final image is bit for bit an uninterrupted
    run's: batch bi renders with rng.fold_in(key, bi), so the batches do
    not depend on where a run stopped.

    on_batch(mean image (H, W, 3) numpy, batches_done, n_batches) is
    called after every batch (the progressive front end, cli
    --progressive; the reference's progressive GL blit,
    src/MiroWindow.cpp:471-488).

    Returns the averaged (H, W, 3) image on the scene's device.
    """
    from ..render import renderer

    dev = scene.geom.vertices.device
    n_batches = -(-spp_total // spp_batch)
    acc = torch.zeros((settings.height, settings.width, 3),
                      dtype=torch.float32, device=dev)
    done = 0
    if ckpt_path:
        loaded = load_state(ckpt_path, acc)
        if loaded is not None:
            acc, scalars = loaded
            done = int(scalars['batches_done'])
            if int(scalars.get('spp_batch', spp_batch)) != spp_batch:
                raise ValueError('resume with a different spp_batch')
            if log:
                console.info('resuming at batch %d/%d from %s',
                             done, n_batches, ckpt_path)

    for bi in range(done, n_batches):
        img = renderer.render(scene, cam, settings, rng.fold_in(key, bi),
                              spp=spp_batch)
        acc = acc + img * spp_batch
        if ckpt_path and ((bi + 1) % save_every == 0 or bi + 1 == n_batches):
            save_state(ckpt_path, acc, batches_done=bi + 1,
                       spp_batch=spp_batch)
        if on_batch is not None:
            on_batch((acc / ((bi + 1) * spp_batch)).cpu().numpy(), bi + 1,
                     n_batches)
        if log:
            console.debug('batch %d/%d done', bi + 1, n_batches)
    return acc / (n_batches * spp_batch)


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's per-parameter state tensors, keyed
    '<param index>.<name>' (Adam: step, exp_avg, exp_avg_sq)."""
    return {f'{i}.{name}': v
            for i, st in optimizer.state_dict()['state'].items()
            for name, v in st.items() if isinstance(v, torch.Tensor)}


def save_train_state(path: str, params: dict, optimizer, step: int,
                     loss: float = float('nan')) -> None:
    """Checkpoint an inverse-rendering run: the parameter leaves (the tree
    (params, optimizer tensors), as the JAX package saves (params,
    opt_state)), the optimizer's state tensors, the step and the loss.
    The optimizer state is torch's (a torch Adam's step and moments): it
    cannot load an optax state from a JAX checkpoint, nor the JAX package
    this one; the parameter leaves load either way."""
    opt = _optimizer_tensors(optimizer)
    save_state(path, (params, opt), step=step, loss=loss,
               optimizer_keys=np.asarray(sorted(opt), dtype=str))


def load_train_state(path: str, params: dict, optimizer):
    """Restore a run saved by save_train_state -> (params, optimizer,
    step), or None if no checkpoint exists. The leaves are copied into
    `params` in place (the optimizer holds those tensors) and the
    optimizer's state is loaded into `optimizer`."""
    if not os.path.exists(path):
        return None
    keys = [str(k) for k in _read(path)['scalar_optimizer_keys']]
    (loaded, opt), scalars = load_state(path, (params, dict.fromkeys(keys,
                                                                     0)))
    with torch.no_grad():
        for k, v in loaded.items():
            params[k].copy_(torch.as_tensor(v))
    sd = optimizer.state_dict()
    state: dict = {}
    for k, v in opt.items():
        i, name = k.split('.', 1)
        state.setdefault(int(i), {})[name] = torch.as_tensor(v)
    sd['state'] = state
    optimizer.load_state_dict(sd)
    return params, optimizer, int(scalars['step'])
