"""The port's front end: checkpoints, progressive renders, the CLI and the
render statistics, against the JAX package where it has a counterpart.

Checkpoints keep the JAX package's file layout, so each package loads the
other's; a progressive render resumed from its checkpoint equals the
uninterrupted one bit for bit, through the API and through the CLI; the
CLI writes the PPM that render + to_u8 + write_ppm write at its seed; the
BVH's structural stats and a wavefront's test counters equal the JAX
package's on the same BVH.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.utils import checkpoint as jck
from raytracer_tpu.utils import profiling as jprof
import raytracer_tpu_torch as rt
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.core import rng
from raytracer_tpu_torch.io import imageio
from raytracer_tpu_torch.parallel import sharding
from raytracer_tpu_torch.render import camera as tcam
from raytracer_tpu_torch.render import renderer as trenderer
from raytracer_tpu_torch.scenes import registry
from raytracer_tpu_torch.utils import checkpoint as ck
from raytracer_tpu_torch.utils import profiling as prof

from .test_torch_render import _assert_images_close
from .torch_port_util import cpu, to_port

SIZE = 12


def test_save_load_round_trip(tmp_path):
    """Dicts by sorted key, tuples in order, None without a leaf; tensors
    come back on the like tree's device, other leaves as arrays."""
    rs = np.random.default_rng(0)
    tree = {'b': (torch.from_numpy(rs.normal(size=(3, 2)).astype(np.float32)),
                  rs.integers(0, 9, 4)),
            'a': torch.arange(5, dtype=torch.int32), 'none': None,
            'c': [torch.ones(()), 2.5]}
    path = str(tmp_path / 'state.npz')
    ck.save_state(path, tree, step=7, loss=0.25)
    like = {'b': (torch.zeros(3, 2), np.zeros(4)), 'a': torch.zeros(5),
            'none': None, 'c': [torch.zeros(()), 0.0]}
    got, scalars = ck.load_state(path, like)
    assert int(scalars['step']) == 7 and float(scalars['loss']) == 0.25
    assert torch.equal(got['a'], tree['a']) and got['none'] is None
    assert torch.equal(got['b'][0], tree['b'][0])
    np.testing.assert_array_equal(got['b'][1], tree['b'][1])
    assert isinstance(got['c'], list) and float(got['c'][1]) == 2.5
    with np.load(path) as z:       # the JAX package's keys
        assert {'magic', '__treedef__', 'leaf_0', 'scalar_step'} <= \
            set(z.files)
        assert bytes(z['magic']).decode() == ck._MAGIC
    # the JAX package loads the port's file in the same leaf order
    jtree = jax.tree_util.tree_map(np.asarray, {
        'a': np.zeros(5), 'b': (np.zeros((3, 2)), np.zeros(4)),
        'c': [np.zeros(()), 0.0]})
    want, _ = jck.load_state(path, jtree)
    np.testing.assert_array_equal(want['b'][0], tree['b'][0].numpy())
    assert ck.load_state(str(tmp_path / 'missing.npz'), like) is None
    np.savez(str(tmp_path / 'other.npz'), x=np.zeros(2))
    with pytest.raises(ValueError, match='checkpoint'):
        ck.load_state(str(tmp_path / 'other.npz'), like)


def test_loads_a_jax_checkpoint(tmp_path):
    """A progressive-render checkpoint written by the JAX package (one
    array and the batch cursor) loads into the port."""
    acc = np.random.default_rng(1).uniform(size=(4, 5, 3)).astype(
        np.float32)
    path = str(tmp_path / 'jax.npz')
    jck.save_state(path, acc, batches_done=3, spp_batch=2)
    got, scalars = ck.load_state(path, torch.zeros(4, 5, 3))
    assert isinstance(got, torch.Tensor) and torch.equal(
        got, torch.from_numpy(acc))
    assert int(scalars['batches_done']) == 3


@pytest.fixture(scope='module')
def scene():
    return cpu(registry.triangle_sphere, size=SIZE)


class _Stop(Exception):
    pass


def test_render_progressive_resumes(tmp_path, scene):
    """Stopped after its first batch and resumed from the checkpoint, the
    render equals the uninterrupted one bit for bit."""
    s, cam, st = scene
    key = rng.PRNGKey(4)
    whole = ck.render_progressive(s, cam, st, key, spp_total=3)
    path = str(tmp_path / 'prog.npz')

    def stop(img, done, total):
        assert img.shape == (SIZE, SIZE, 3) and total == 3
        raise _Stop

    with pytest.raises(_Stop):
        ck.render_progressive(s, cam, st, key, spp_total=3,
                              ckpt_path=path, on_batch=stop)
    _, scalars = ck.load_state(path, whole)
    assert int(scalars['batches_done']) == 1
    seen = []
    resumed = ck.render_progressive(
        s, cam, st, key, spp_total=3, ckpt_path=path,
        on_batch=lambda img, done, total: seen.append(done))
    assert seen == [2, 3] and torch.equal(resumed, whole)
    # batch bi draws from fold_in(key, bi)
    first = rt.render(s, cam, st, rng.fold_in(key, 0))
    assert not torch.equal(first, whole)
    with pytest.raises(ValueError, match='spp_batch'):
        ck.render_progressive(s, cam, st, key, spp_total=4, spp_batch=2,
                              ckpt_path=path)


def test_train_state_round_trip(tmp_path, scene):
    """The six leaves and the Adam moments saved after a step, loaded into
    fresh parameters and a fresh optimizer: the next step is the same."""
    s, cam, st = scene
    target = torch.zeros(SIZE, SIZE, 3)
    params = sharding.get_params(s)
    opt = sharding.make_optimizer(params, lr=1e-2)
    params, loss = sharding.train_step(params, opt, s, cam, st, target,
                                       rng.PRNGKey(1))
    path = str(tmp_path / 'train.npz')
    ck.save_train_state(path, params, opt, step=1, loss=float(loss))
    fresh = sharding.get_params(s)
    opt2 = sharding.make_optimizer(fresh, lr=1e-2)
    fresh, opt2, step = ck.load_train_state(path, fresh, opt2)
    assert step == 1
    for k in sharding.PARAM_KEYS:
        assert torch.equal(fresh[k], params[k]), k
    a, _ = sharding.train_step(params, opt, s, cam, st, target,
                               rng.PRNGKey(2))
    b, _ = sharding.train_step(fresh, opt2, s, cam, st, target,
                               rng.PRNGKey(2))
    for k in sharding.PARAM_KEYS:
        assert torch.equal(a[k], b[k]), k
    assert ck.load_train_state(str(tmp_path / 'none.npz'), fresh,
                               opt2) is None


def _cli(tmp_path, name, *extra, size=SIZE):
    out = str(tmp_path / f'{name}.ppm')
    assert cli.main(['--scene', 'triangle_sphere', '--size', str(size),
                     '--seed', '11', '--device', 'cpu', '--out', out,
                     *extra]) == 0
    return out


@pytest.mark.parametrize('size', [SIZE, 40])
def test_cli_writes_the_render(tmp_path, size):
    """The PPM of render + to_u8 + write_ppm at the CLI's seed and the
    registry's settings; a frame of more pixels than the CPU's ray tile
    (40 x 40 > 1,024) renders in two tiles."""
    s, cam, st = cpu(registry.triangle_sphere, size=size)
    out = _cli(tmp_path, 'plain', '--spp', '2', size=size)
    want = str(tmp_path / 'want.ppm')
    imageio.write_ppm(want, rt.to_u8(rt.render(s, cam, st, rng.PRNGKey(11),
                                               spp=2)).numpy())
    assert open(out, 'rb').read() == open(want, 'rb').read()
    img, _ = imageio.load_ppm(out)
    assert img.shape == (size, size, 3) and img.max() > 0


def test_cli_matches_the_jax_cli(tmp_path):
    """The same flags and seed give the JAX CLI's image, under the render
    rule of test_torch_render.py, for a frame of two ray tiles."""
    from raytracer_tpu import cli as jcli
    flags = ['--scene', 'triangle_sphere', '--size', '40', '--spp', '1',
             '--seed', '11']
    want = str(tmp_path / 'jax.ppm')
    assert jcli.main(flags + ['--out', want]) == 0
    got = _cli(tmp_path, 'port', '--spp', '1', size=40)
    (a, _), (b, _) = imageio.load_ppm(got), imageio.load_ppm(want)
    _assert_images_close(a.astype(np.float32), b.astype(np.float32))


def test_cli_progressive_resumes(tmp_path, monkeypatch):
    """--progressive with --ckpt: a run to 1 spp, then resumed to 2, writes
    the bytes of an uninterrupted 2-spp run."""
    whole = _cli(tmp_path, 'whole', '--spp', '2', '--progressive', '1')
    ckpt = str(tmp_path / 'cli.npz')
    _cli(tmp_path, 'resumed', '--spp', '1', '--progressive', '1', '--ckpt',
         ckpt)
    calls = []
    real = rt.render
    monkeypatch.setattr(trenderer, 'render',
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    resumed = _cli(tmp_path, 'resumed', '--spp', '2', '--progressive', '1',
                   '--ckpt', ckpt)
    assert len(calls) == 1             # only the second batch rendered
    assert open(resumed, 'rb').read() == open(whole, 'rb').read()


def test_cli_defaults_to_the_card(tmp_path, capsys):
    assert cli.main(['--list-scenes']) == 0
    assert 'sponza_standin' in capsys.readouterr().out.split()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(['--size', '8', '--out', str(tmp_path / 'x.ppm')])


@pytest.fixture(scope='module')
def bvh_pair():
    kw = dict(width=8, height=8, bvh=True)
    sj = cpu(registry.instanced_teapots_standin, builder=rj.SceneBuilder(),
             **kw)[0]
    return sj, to_port(sj)


def test_bvh_stats_equal(bvh_pair):
    sj, sp = bvh_pair
    got = prof.bvh_stats(sp.blas)
    assert got == jprof.bvh_stats(sj.blas)
    assert got['inst_leaves'] > 0 and got['tri_leaves'] > 0


def test_trace_stats_equal(bvh_pair):
    sj, sp = bvh_pair
    cam = registry.instanced_teapots_standin(8, 8, device='cpu')[1]
    o, d, _ = tcam.center_rays(cam, 16, 16)
    got = prof.trace_stats(sp, o, d)
    want = jprof.trace_stats(sj, jnp.asarray(o.numpy()),
                             jnp.asarray(d.numpy()))
    assert got == want and got['ray_tri'] > 0
    flat, _, _ = cpu(registry.triangle_sphere, size=8)
    assert prof.trace_stats(flat, o, d)['tri_per_ray'] == flat.num_tris


def test_render_with_stats_and_profile(tmp_path, bvh_pair):
    _, sp = bvh_pair
    _, cam, st = registry.instanced_teapots_standin(8, 8, device='cpu')
    with prof.profile_trace(str(tmp_path / 'trace')):
        img, report = prof.render_with_stats(sp, cam, st, rng.PRNGKey(0),
                                             log=False)
    assert os.path.getsize(tmp_path / 'trace' / 'trace.json') > 0
    assert img.shape == (8, 8, 3) and report.primary_rays == 64
    assert report.probe['rays'] == 64 and report.probe['ray_aabb'] > 0
    text = report.pretty()
    assert 'Probe wavefront' in text and '8x8 @ 1spp' in text
