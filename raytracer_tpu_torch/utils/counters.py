"""The run counters of the port, in one place.

Each counter lives in its module: a CUDA kernel wrapper's `LAUNCHES` and
`MODES` (ops/cuda/*_kernel.py: the trace kernels of `KERNELS`, and the
threefry kernel of core/rng, `RNG`, which every path on the card
launches), a plain tracer's `CALLS`, the alpha
march's `MARCH_PASSES` and `MARCH_SYNCS`, the near-ordered sweep's
`SWEEPS` and `SWEEP_LIVE` and the plain walks' `TESTS`
(ops/cluster_trace.py), the ring's `TRACES` and `ROUNDS`
(ops/ring_trace.py) and the collectives' `STATS`
(parallel/distributed.py). `read` gives them all under flat names and
`reset` sets them to 0.

Under RenderSettings.remat the backward pass replays each bounce step
(render/integrator.radiance), and the replay launches the kernels, marches,
sweeps and goes round the ring a second time. It runs inside
`recomputing`, which keeps the module counters to the forward pass and
adds what the replay counted to `RECOMPUTE`, under `read`'s names, with
`steps`, the bounce steps replayed.
"""
from __future__ import annotations

import collections
import contextlib

from ..ops import cluster_trace as ct, icluster_trace as ict
from ..ops import iseg_trace as ist, mt_trace as tmt, ring_trace as ring
from ..ops import traverse as ttr
from ..ops.cuda import bvh_kernel as bvk, cluster_kernel as ck
from ..ops.cuda import icluster_kernel as ick, iseg_kernel as isk
from ..ops.cuda import mt_kernel as mtk, rng_kernel as rk
from ..parallel import distributed

KERNELS = dict(cluster_trace=ck, iseg_trace=isk, icluster_trace=ick,
               mt_trace=mtk, bvh_trace=bvk)
RNG = dict(threefry=rk)
PLAINS = (ct, ist, ict, tmt, ttr)
# what the backward pass's replays of bounce steps counted
RECOMPUTE: collections.Counter = collections.Counter()


def _scalars() -> list:
    """(name, module, attribute) of every counter held in a module
    attribute."""
    return ([(f'launches.{k}', m, 'LAUNCHES')
             for k, m in {**KERNELS, **RNG}.items()]
            + [(f'calls.{m.__name__.rsplit(".", 1)[-1]}', m, 'CALLS')
               for m in PLAINS]
            + [('march_passes', ct, 'MARCH_PASSES'),
               ('march_syncs', ct, 'MARCH_SYNCS'), ('sweeps', ct, 'SWEEPS'),
               ('ring_traces', ring, 'TRACES'),
               ('ring_rounds', ring, 'ROUNDS')])


def _tables() -> list:
    """(name prefix, dict) of every counter held in a dict."""
    return ([(f'modes.{k}.', m.MODES) for k, m in {**KERNELS, **RNG}.items()]
            + [('tests.', ct.TESTS), ('', distributed.STATS)])


def read() -> dict:
    """Every counter's value under a flat name: `launches.<kernel>`,
    `modes.<kernel>.<mode>`, `calls.<plain module>`, `march_passes`,
    `march_syncs`, `sweeps`, `ring_traces`, `ring_rounds`,
    `tests.box`, `tests.tri` and distributed.STATS's own keys."""
    out = {name: getattr(m, a) for name, m, a in _scalars()}
    for prefix, d in _tables():
        out.update({prefix + k: v for k, v in d.items()})
    return out


def reset() -> None:
    """Every counter `read` gives to 0: the kernels' launches and modes,
    the plain versions' calls, the march's, the sweeps' and the ring's
    counts, the plain walks' TESTS, the collectives' STATS, and RECOMPUTE
    (SWEEP_LIVE stays with its caller)."""
    for _, m, a in _scalars():
        setattr(m, a, 0)
    for m in (*KERNELS.values(), *RNG.values()):
        m.MODES.clear()
    ct.TESTS.update(box=0, tri=0)
    distributed.reset_stats()
    RECOMPUTE.clear()


@contextlib.contextmanager
def recomputing():
    """Count the work run inside into RECOMPUTE: every module counter
    comes out as it went in."""
    before = read()
    tables = [(d, dict(d)) for _, d in _tables()]
    live = None if ct.SWEEP_LIVE is None else len(ct.SWEEP_LIVE)
    try:
        yield
    finally:
        RECOMPUTE.update({k: v - before.get(k, 0) for k, v in read().items()
                          if v != before.get(k, 0)})
        for name, m, a in _scalars():
            setattr(m, a, before[name])
        for d, v in tables:
            d.clear()
            d.update(v)
        if live is not None:
            del ct.SWEEP_LIVE[live:]
