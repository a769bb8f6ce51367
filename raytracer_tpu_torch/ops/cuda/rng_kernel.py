"""Wrapper of the threefry random-number kernel (csrc/threefry.cu).

Replaces no TPU kernel: it draws core/rng's numbers on the card, which
the plain version (core/rng._threefry2x32, masked int64 torch operations)
would draw in about 170 eager launches a draw. Three modes, each one
launch: `uniform` (float32, core/rng.uniform and uniform_segmented, whose
segment the kernel folds into each output's counter), `bits` (uint32
words as int64, core/rng.random_bits) and `pair` (both words of the
block, core/rng.fold_in of a tensor and split of a batch of keys).

The CUDA source is compiled with nvcc into a shared library with a plain C
entry point on first use (ops/cuda/cluster_kernel.load, which the cluster
kernel's `build` also calls for this one) and called through ctypes on
PyTorch's current stream. Every function here takes CUDA tensors or a CUDA
device only, and launches the kernel or raises; core/rng runs the plain
version for the CPU. `LAUNCHES` counts launches and `MODES` counts them by
mode.
"""
from __future__ import annotations

import collections
import ctypes
import math
import threading

import torch

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
_MODE = dict(uniform=0, bits=1, pair=2)
_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from .cluster_kernel import load
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            _lib = load('threefry', [ctypes.c_int, ctypes.c_uint32,
                                     ctypes.c_uint32, vp, vp, vp,
                                     ctypes.c_int] + [i64] * 5
                        + [vp] * 3)
    return _lib


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'threefry kernel: {device} is not a CUDA device')
    return device


def _key(k1, k2, device):
    """(s1, s2, kb1, kb2): host words, or a batch of keys as contiguous
    int64 tensors on `device`."""
    if isinstance(k1, torch.Tensor):
        kb = []
        for name, k in (('k1', k1), ('k2', k2)):
            if k.device != device or k.dtype != torch.int64:
                raise ValueError(f'threefry kernel: key {name} must be int64 '
                                 f'on {device}, got {k.dtype} on {k.device}')
            kb.append(k.contiguous())
        return 0, 0, kb[0], kb[1]
    return int(k1) & 0xFFFFFFFF, int(k2) & 0xFFFFFFFF, None, None


def _launch(mode: str, key, n: int, per_key: int, device, out1, out2=None,
            data=None, dim: int = 1, seg: int = 1, inner: int = 1):
    global LAUNCHES
    s1, s2, kb1, kb2 = key
    if n == 0:
        return
    if n >= 2 ** 31:
        raise ValueError(f'threefry kernel: {n} outputs exceed the int32 '
                         f'indexing')
    lib = build()
    ptr = (lambda x: None if x is None else x.data_ptr())
    err = lib.rt_threefry(
        _MODE[mode], s1, s2, ptr(kb1), ptr(kb2), ptr(data),
        int(data is not None and data.dtype == torch.int64), n, per_key, dim,
        seg, inner, ptr(out1), ptr(out2),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'threefry kernel launch failed: CUDA error {err}')
    LAUNCHES += 1
    MODES[mode] += 1


def draw(k1, k2, shape, device, mode: str = 'uniform', segment=None,
         axis: int = 0) -> torch.Tensor:
    """core/rng.uniform_segmented (mode 'uniform', float32) or
    random_bits (mode 'bits', int64 holding uint32) of the key (k1, k2) on
    a CUDA `device`: host words, or a batch of keys (int64 tensors of one
    shape there), which gives keys' shape + shape. `segment` along `axis`
    as uniform_segmented (one key only)."""
    shape = tuple(int(s) for s in shape)
    device = _card(k1.device if isinstance(k1, torch.Tensor) else device)
    key = _key(k1, k2, device)
    batch = tuple(k1.shape) if key[2] is not None else ()
    per_key = math.prod(shape)
    dim = seg = inner = 1
    if segment is not None:
        if batch:
            raise ValueError('threefry kernel: a segmented draw takes one key')
        dim, seg, inner = shape[axis], int(segment), math.prod(
            shape[axis + 1:])
    out = torch.empty(batch + shape, device=device,
                      dtype=torch.float32 if mode == 'uniform'
                      else torch.int64)
    _launch(mode, key, out.numel(), max(per_key, 1), device, out, dim=dim,
            seg=seg, inner=inner)
    return out


def pair(k1, k2, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both words of threefry on the counter pairs (0, data) under the key
    (k1, k2), host words or int64 tensors broadcast with data, on data's
    CUDA device -> two int64 tensors of the broadcast shape (a batch of
    keys)."""
    device = _card(data.device)
    if isinstance(k1, torch.Tensor):
        k1, k2, data = torch.broadcast_tensors(k1, k2, data)
    if data.dtype not in (torch.int32, torch.int64):
        data = data.to(torch.int64)
    data = data.contiguous()
    key = _key(k1, k2, device)
    x1 = torch.empty(data.shape, dtype=torch.int64, device=device)
    x2 = torch.empty_like(x1)
    _launch('pair', key, data.numel(), 1, device, x1, x2, data=data)
    return x1, x2
