"""Parent against change on the benchmark, in pairs, on one card.

    python3 scripts/bench_pairs.py PARENT_DIR --out DIR [--pairs 10]

Runs `python -m raytracer_tpu_torch.bench --no-profile` in PARENT_DIR (a
copy of the parent commit, e.g. `git archive HEAD | tar -x -C _parent`
before committing, in a directory .gitignore lists) and in this checkout,
`pairs` times each, each invocation in a process of its own, alternating
which side of a pair runs first (parent then change, change then parent,
...), and keeps each one's output in DIR/<pair>_<side>.log. Prints one
JSON line per cell and metric: each side's values in run order, their
quartiles, and the pairs the change won (better by the metric's
direction; ties count for neither). Exits 1 if an invocation fails or a
run fails the gate.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHER = {'primary_rays_per_sec': True, 'peak_device_memory_gb': False,
          'setup_s': False}


def invoke(tree: str, log: str) -> dict | None:
    """One benchmark invocation in `tree` -> its last line, or None."""
    with open(log, 'w') as f:
        res = subprocess.run(
            [sys.executable, '-m', 'raytracer_tpu_torch.bench',
             '--no-profile'], cwd=tree, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        f.write(res.stdout)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{')]
    return json.loads(lines[-1]) if res.returncode == 0 and lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('parent')
    ap.add_argument('--pairs', type=int, default=10)
    ap.add_argument('--out', required=True)
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    trees = dict(parent=os.path.abspath(a.parent), change=REPO)
    runs = dict(parent=[], change=[])
    ok = True
    for i in range(a.pairs):
        order = ('parent', 'change') if i % 2 == 0 else ('change', 'parent')
        for side in order:
            last = invoke(trees[side], os.path.join(a.out,
                                                    f'{i}_{side}.log'))
            print(json.dumps(dict(pair=i, side=side, ok=bool(
                last and last['ok']))), flush=True)
            ok = ok and bool(last and last['ok'])
            runs[side].append(last)
    if not ok:
        return 1
    device = runs['change'][0]['device']
    for cell in runs['change'][0]['workloads']:
        for metric, higher in HIGHER.items():
            val = {side: [r['workloads'][cell]['metrics'][metric]['value']
                          for r in runs[side]] for side in runs}
            sign = 1.0 if higher else -1.0
            wins = sum(sign * (c - p) > 0
                       for p, c in zip(val['parent'], val['change']))
            q = {side: np.percentile(v, [25, 50, 75]).tolist()
                 for side, v in val.items()}
            print(json.dumps(dict(
                workload=cell, metric=metric, change_wins=wins,
                pairs=a.pairs, quartiles=q, values=val,
                device=device.get('smi', device['kind']))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
