"""The scaling harness (raytracer_tpu_torch/scaling.py, the counterpart of
scripts/scaling.py) on gloo ranks on the CPU.

`python -m raytracer_tpu_torch.scaling` with 1 and 2 ranks on the registry's
`cornell_pt` from the stand-in asset tree at 8x8: one JSON line a rank
count (the slowest rank's wall and the rays/s it gives, each rank's wall)
and then `scaling_efficiency`; CPU ranks, and ranks that share a card, are
marked as no scaling figure.
"""
import json
import subprocess
import sys

import pytest

from raytracer_tpu_torch import scaling
from raytracer_tpu_torch.parallel import worker

from .test_torch_asset_scenes import tree  # noqa: F401


@pytest.mark.parametrize('flags,task', [([], 'render'),
                                        (['--train', '--geometry'],
                                         'step_geometry')])
def test_scaling_lines_on_cpu_ranks(tree, monkeypatch, flags, task):
    monkeypatch.setenv('RT_ASSETS', tree[0])
    out = subprocess.run(
        [sys.executable, '-m', 'raytracer_tpu_torch.scaling', '--device',
         'cpu', '--backend', 'gloo', '--ranks', '1,2', '--size', '8',
         '--iters', '1', *flags], cwd=worker.PKG_ROOT, capture_output=True,
        text=True, timeout=300, check=True).stdout
    lines = [json.loads(x) for x in out.splitlines()]
    assert len(lines) == 3
    for n, line in zip((1, 2), lines):
        assert line['ranks'] == n and line['task'] == task
        assert line['workload'] == ('fwd+bwd' if flags else 'forward')
        assert line['rays'] == 64 and len(line['rank_walls_s']) == n
        assert line['wall_s'] == max(line['rank_walls_s']) > 0
        assert line['rays_per_sec'] == 64 / line['wall_s']
        assert line['cards'] == 0 and 'no scaling figure' in line['note']
    eff = lines[2]
    assert eff['scaling_efficiency'] == pytest.approx(
        lines[1]['rays_per_sec'] / (2 * lines[0]['rays_per_sec']))
    assert (eff['from_ranks'], eff['to_ranks'], eff['target']) == (1, 2, 0.85)
    assert not eff['scaling_figure'] and 'CPU' in eff['note']


def test_ranks_that_share_a_card_are_no_scaling_figure():
    assert 'share 1 card' in scaling.note(2, ['GPU-0'])
    assert scaling.note(2, ['GPU-0', 'GPU-1']) is None
    rows = [dict(ranks=1, rays_per_sec=100.0, workload='forward', cards=1,
                 note=None),
            dict(ranks=4, rays_per_sec=340.0, workload='forward', cards=4,
                 note=None)]
    eff = scaling.efficiency(rows)
    assert eff['scaling_efficiency'] == pytest.approx(0.85)
    assert eff['scaling_figure'] and eff['note'] is None
