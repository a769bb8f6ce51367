"""Scaling harness: rays/s of the data-parallel frame or training step
against the rank count.

    python -m raytracer_tpu_torch.scaling [--scene cornell_pt] [--size 256]
        [--spp 1] [--iters 3] [--tile N] [--train] [--geometry]
        [--ranks 1,2,4] [--backend nccl|gloo] [--device cuda|cpu]

The counterpart of scripts/scaling.py. Each rank count runs as ranks of
parallel/worker.py (`worker.launch`: one process a rank, each with a
deadline) on the registry scene built with size=--size, bvh=True and two
bounces (the JAX script's), at --spp samples a pixel. The measured task
is the forward render (`render_sharded`), or with --train the fwd+bwd
step (`loss_and_grads_scanned`, tiles shared out over the ranks, the
BASELINE metric); --geometry takes the geometry-sharded ring instead
(`render_geometry_sharded`, `loss_and_grads_geometry_sharded`). A rank
runs the task --iters + 1 times and the first run is its warm-up; a
count's wall is the slowest rank's mean warm run.

Prints one JSON line a rank count (ranks, rays/s, the slowest rank's
wall, each rank's wall and peak memory, the number of distinct cards the
ranks ran on) and, for two counts or more, `scaling_efficiency`: the
last count's rays/s over the first's times the ratio of ranks, beside
BASELINE's 0.85 target. NCCL takes one card a rank; gloo ranks may share
one card or run on the CPU (`--device cpu`). Ranks that share a card,
or the CPU's cores, share its compute: their figures test the plumbing
and are no scaling figure, and the lines say so.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

from .parallel import worker

TARGET = 0.85       # BASELINE.json: rays/s scaling efficiency to >= 2 hosts


def launch(n: int, scene: str, scene_kw: dict, tasks: list, iters: int,
           spp: int = 1, tile: int | None = None, backend: str = 'nccl',
           device: str = 'cuda', seed: int = 0,
           timeout: float = 600.0) -> dict:
    """n ranks running `tasks` iters + 1 times each, all within `timeout`
    seconds -> the worker's arrays, with `stats` (each rank's, by task)
    parsed."""
    args = ['--scene', scene, '--scene-kw', json.dumps(scene_kw),
            '--tasks', ','.join(tasks), '--repeat', iters + 1,
            '--spp', spp, '--seed', seed]
    if tile:
        args += ['--tile', tile]
    with tempfile.TemporaryDirectory() as tmp:
        res = worker.launch(n, args, os.path.join(tmp, 'out.npz'),
                            device=device, backend=backend, timeout=timeout)
    res['stats'] = json.loads(str(res['stats']))
    return res


def figures(res: dict, task: str, spp: int = 1) -> dict:
    """One rank count's line: the slowest rank's mean warm wall and the
    rays/s it gives, each rank's walls and peak memory, and the cards."""
    stats = [s[task] for s in res['stats']]
    n = len(stats)
    walls = [statistics.mean(s['walls'][1:] or s['walls']) for s in stats]
    wall = max(walls)
    rays = stats[0]['pixels'] * spp
    cards = sorted({s['card'] for s in stats})
    return {'ranks': n, 'workload': 'fwd+bwd' if task.startswith('step')
            else 'forward', 'task': task, 'rays': rays,
            'rays_per_sec': rays / wall, 'rays_per_sec_per_rank':
            rays / wall / n, 'wall_s': wall, 'rank_walls_s': walls,
            'peak_mem_gb': [s.get('peak_mem_gb') for s in stats],
            'cards': len([c for c in cards if c != 'cpu']),
            'note': note(n, cards)}


def note(n: int, cards: list) -> str | None:
    """What the figure is worth: None when every rank has a card of its
    own."""
    if 'cpu' in cards:
        return (f'{n} rank(s) on the CPU share its cores: the plumbing is '
                f'checked, no scaling figure')
    if len(cards) < n:
        return (f'{n} ranks share {len(cards)} card(s): the plumbing is '
                f'checked, no scaling figure')
    return None


def efficiency(rows: list) -> dict:
    """scripts/scaling.py's summary of two counts or more: rays/s at the
    last count over the first's times the ratio of ranks."""
    first, last = rows[0], rows[-1]
    eff = last['rays_per_sec'] / (first['rays_per_sec'] * last['ranks']
                                  / first['ranks'])
    notes = [r['note'] for r in rows if r['note']]
    return {'scaling_efficiency': eff, 'from_ranks': first['ranks'],
            'to_ranks': last['ranks'], 'workload': last['workload'],
            'target': TARGET, 'cards': last['cards'],
            'scaling_figure': not notes, 'note': notes[-1] if notes
            else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--scene', default='cornell_pt')
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--spp', type=int, default=1)
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--tile', type=int, default=0,
                    help='ray tile of --train (0: the settings\' tile)')
    ap.add_argument('--train', action='store_true',
                    help='the fwd+bwd step instead of the forward render')
    ap.add_argument('--geometry', action='store_true',
                    help='the geometry-sharded ring instead of data '
                         'parallelism')
    ap.add_argument('--ranks', default='1,2',
                    type=lambda s: [int(x) for x in s.split(',')])
    ap.add_argument('--backend', choices=['nccl', 'gloo'], default='nccl')
    ap.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    a = ap.parse_args(argv)
    task = ('step' if a.train else 'render') + ('_geometry' if a.geometry
                                                 else '')
    kw = dict(size=a.size, bvh=True, max_bounces=2)
    rows = []
    for n in a.ranks:
        res = launch(n, a.scene, kw, [task], a.iters, a.spp, a.tile or None,
                     a.backend, a.device)
        rows.append(figures(res, task, a.spp))
        print(json.dumps(rows[-1]), flush=True)
    if len(rows) > 1:
        print(json.dumps(efficiency(rows)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
