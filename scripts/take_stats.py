"""What the take-scatter kernel sees on a run's take gradients: the counts
that scripts/torch_frame_profile.py (--train, the corners bounce by bounce)
and chip_smoke.py (phase 42) print.

    from scripts.take_stats import stats, watched_takes

`watched_takes()` keeps a clone of every take gradient that
core/vecmath.scatter_rows sees while it is open, (table shape, gradient,
index), in the backward's order; `stats(grad, idx)` counts what one launch
on such a gradient meets. Both work on either device; neither is used by
the port itself.
"""
from __future__ import annotations

import contextlib

import torch

from raytracer_tpu_torch.core import vecmath as vm


@contextlib.contextmanager
def watched_takes(shapes=None):
    """Yield a list that gathers (table shape, gradient, index) for each
    take gradient scattered while the context is open, cloned; with
    `shapes`, only those into a table of one of those shapes."""
    seen, scatter_rows = [], vm.scatter_rows

    def watched(g, idx, shape):
        if shapes is None or tuple(shape) in shapes:
            seen.append((tuple(shape), g.detach().clone(), idx.clone()))
        return scatter_rows(g, idx, shape)
    vm.scatter_rows = watched
    try:
        yield seen
    finally:
        vm.scatter_rows = scatter_rows


def stats(grad: torch.Tensor, idx: torch.Tensor, chunks=(2048,)) -> dict:
    """What a launch on grad (N, K, C) and idx (N, K) sees, counted with
    plain tensor operations on either device: the entries (N x K), those
    whose C values are all exactly zero, the distinct rows, the row that
    the most entries name with its entries and its zero entries, the mean
    run length of equal rows along a warp's column (32 rows), the global
    adds of a run-summing design without a table (one a channel for each
    run of equal rows in a 256-row tile's column), and for each chunk size
    in `chunks` the distinct rows with a nonzero contribution summed over
    the chunks of that many rows (a block-private table's adds, one a row
    and chunk)."""
    N, K, C = grad.shape
    key = idx.reshape(N, K).long()
    zero = (grad == 0).all(dim=-1)
    n = torch.arange(N, device=key.device)[:, None]
    change = torch.ones_like(key, dtype=torch.bool)
    change[1:] = key[1:] != key[:-1]

    def runs(width):
        return int((change | (n % width == 0)).sum())
    rows = int(key.max()) + 1 if N else 1
    count = torch.bincount(key.reshape(-1), minlength=rows)
    top = int(count.argmax())
    nz, at = key[~zero], n.expand(N, K)[~zero]
    return dict(entries=N * K, zero_entries=int(zero.sum()),
                distinct_rows=int((count > 0).sum()), top_row=top,
                top_row_entries=int(count[top]),
                top_row_zero_entries=int((zero & (key == top)).sum()),
                mean_run=N * K / max(runs(32), 1), run_adds=C * runs(256),
                chunk_rows={c: int(torch.unique(at // c * rows + nz).numel())
                            for c in chunks})
