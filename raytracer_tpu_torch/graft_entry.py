"""Entry points of the port, the counterparts of __graft_entry__.py.

entry(): a small forward render -> (fn, example_args), fn(*example_args)
the (H, W, 3) image.

dryrun_multichip(n): n ranks (parallel/worker.py) run two
sharding.train_step(mesh=) steps and one sharding.loss_and_grads(mesh),
each loss and gradient asserted finite, and the ranks agree on the
parameters.

Both use `sponza_standin` at a small size where the JAX package uses
`cornell_pt`: that scene reads OBJ and image files that this repository
does not hold, and the atrium, generated from its seed, takes the same
paths (clusters, textures, path tracing, a rect light).
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .core import rng
from .parallel import worker
from .render import renderer
from .scenes import registry

SMALL = dict(width=16, height=12, max_bounces=2)


def entry(device='cuda'):
    scene, cam, settings = registry.sponza_standin(64, 48, max_bounces=3,
                                                   device=device)

    def fn(scene, cam, key):
        return renderer.render(scene, cam, settings, key, spp=1)

    return fn, (scene, cam, rng.PRNGKey(0))


def dryrun_multichip(n_devices: int, device: str = 'cuda',
                     timeout: float = 300.0) -> dict:
    """Two train steps and one whole-image loss over n ranks -> the arrays
    rank 0 wrote. On the CPU the ranks are gloo ones; on the card the
    backend defaults to NCCL where there is a card a rank, else gloo ranks
    sharing the cards."""
    backend = 'gloo' if device == 'cpu' or \
        torch.cuda.device_count() < n_devices else 'nccl'
    with tempfile.TemporaryDirectory() as tmp:
        res = worker.launch(
            n_devices, ['--scene', 'sponza_standin', '--scene-kw',
                        json.dumps(SMALL), '--tasks', 'train,loss',
                        '--tile', '64'],
            os.path.join(tmp, 'dryrun.npz'), device=device, backend=backend,
            timeout=timeout)
    losses = np.append(res['train/losses'], res['loss/loss'])
    assert losses.shape == (3,) and np.isfinite(losses).all(), losses
    sums = {json.dumps(s['train']['param_sum'])
            for s in json.loads(str(res['stats']))}
    assert len(sums) == 1, f'the ranks hold other parameters: {sums}'
    return res
