"""Wrapper of the take-scatter kernel (csrc/grad/take_scatter.cu).

Replaces no TPU kernel: it is the backward of core/vecmath.take on the
card, the scatter-add that XLA makes of the JAX package's gathers and that
autograd makes of index_select (index_add, one global atomic an element).
`scatter(grad, idx, rows)` adds a float32 gradient (N, K, C) into a zeroed
(rows, C) table at the rows the index (N, K) names, one launch, summing
each run of equal indices before it adds. Two modes: `table_shared` (the
table fits in a block's shared memory: the material rows) and
`table_global` (the vertices, the texel pool).

The CUDA source is compiled with nvcc into a shared library with a plain C
entry point on first use (ops/cuda/cluster_kernel.load, which the cluster
kernel's `build` also calls for this one) and called through ctypes on
PyTorch's current stream. `scatter` takes CUDA tensors only and launches
the kernel or raises; core/vecmath runs the plain version (index_add_) for
the CPU. `LAUNCHES` counts launches and `MODES` counts them by mode.
"""
from __future__ import annotations

import collections
import ctypes
import threading

import torch

LAUNCHES = 0
MODES: collections.Counter = collections.Counter()
# the kernel's warps a block, whose runs take 2 * WARPS * C floats of shared
# memory beside a table_shared table, within SHARED_BYTES
WARPS = 8
SHARED_BYTES = 47 * 1024
_lib = None
_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from .cluster_kernel import load
            vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            _lib = load('take_scatter', [vp, vp, ci, vp] + [i64] * 4
                        + [ci, vp])
    return _lib


def mode(rows: int, C: int) -> str:
    """The mode of a launch into a (rows, C) table."""
    floats = rows * C + 2 * WARPS * C
    return 'table_shared' if 4 * floats <= SHARED_BYTES else 'table_global'


def scatter(grad: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """out (rows, C) float32 with out[idx[n, k]] += grad[n, k] for the
    contiguous float32 grad (N, K, C) and int32 or int64 idx (N, K) on one
    CUDA device; an empty grad launches nothing."""
    global LAUNCHES
    dev = grad.device
    if dev.type != 'cuda':
        raise ValueError(f'take-scatter kernel: {dev} is not a CUDA device')
    if grad.dim() != 3 or grad.dtype != torch.float32 \
            or not grad.is_contiguous():
        raise ValueError(f'take-scatter kernel: grad must be a contiguous '
                         f'float32 (N, K, C) tensor, got {grad.dtype} '
                         f'{tuple(grad.shape)}')
    N, K, C = grad.shape
    if idx.device != dev or idx.dtype not in (torch.int32, torch.int64) \
            or tuple(idx.shape) != (N, K) or not idx.is_contiguous():
        raise ValueError(f'take-scatter kernel: idx must be a contiguous '
                         f'int32 or int64 ({N}, {K}) tensor on {dev}, got '
                         f'{idx.dtype} {tuple(idx.shape)} on {idx.device}')
    if N * K >= 2 ** 31 or rows * C >= 2 ** 31:
        raise ValueError(f'take-scatter kernel: {N} x {K} indices into '
                         f'{rows} x {C} entries exceed the int32 indexing')
    out = torch.zeros((rows, C), dtype=torch.float32, device=dev)
    if N * K * C == 0:
        return out
    m = mode(rows, C)
    lib = build()
    err = lib.rt_take_scatter(
        grad.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), N, K, C, rows, int(m == 'table_shared'),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'take-scatter kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES += 1
    MODES[m] += 1
    return out
