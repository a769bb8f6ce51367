"""The registry's asset scenes in the port against the JAX package's, on the
CPU, built from one stand-in asset tree (scenes/assets.write_tree) written
to disk.

The JAX registry reads the tree through its module paths (ASSETS, MODELS,
TEXTURES, patched here), the port through RT_ASSETS. Both load the same
files with their own loaders and build with their own SceneBuilder, so
every scene array must be byte-equal (the JAX build carried across with
convert.py's keys; `materials.kt`, which the port does not keep, aside),
and the camera and settings equal. The renders are held in
tests/test_torch_asset_renders.py and tests/test_torch_asset_forest.py.
"""
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from raytracer_tpu.io import imageio as jio
from raytracer_tpu.io import objload as jobj
from raytracer_tpu.scenes import registry as jreg
from raytracer_tpu_torch import cli, convert
from raytracer_tpu_torch.io import imageio as tio
from raytracer_tpu_torch.io import objload as tobj
from raytracer_tpu_torch.scenes import assets, registry

from .torch_port_util import scene_arrays

ASSET_SCENES = ('alpha_leaf', 'cornell_pt', 'cornell_spheres', 'dispersion',
                'dome_teapot', 'final_forest', 'instanced_grid',
                'instanced_teapots', 'mb_bullet', 'sponza_proxy',
                'teapot_blinn')
FOREST = dict(width=16, height=12, n_trees=3, n_flowers=2, grass_grid=2)
# each scene at a small size and count, every branch of its builder
BUILDS = {
    'cornell_pt': dict(size=16),
    'cornell_spheres': dict(size=16),
    'teapot_blinn': dict(size=16, spec=False),
    'dome_teapot': dict(size=16),
    'dome_teapot_stone': dict(size=16, ground='stone'),
    'mb_bullet': dict(size=16, shutter=0.5),
    'instanced_teapots': dict(size=16, grid=3),
    'instanced_grid': dict(size=16, n=64),
    'sponza_proxy': dict(width=16, height=12, n_teapots=12),
    'sponza_proxy_hd': dict(width=16, height=12, hd=True, n_teapots=12),
    'alpha_leaf': dict(size=16),
    'dispersion': dict(size=16, bvh=False),
    'final_forest': FOREST,
    'final_forest_flat': dict(FOREST, flatten=True),
}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The stand-in tree, written once -> (root, relative paths)."""
    root = str(tmp_path_factory.mktemp('assets'))
    return root, assets.write_tree(root)


def point_at(monkeypatch, root):
    """Both registries read `root`: the JAX one through its module paths,
    the port through RT_ASSETS."""
    monkeypatch.setattr(jreg, 'ASSETS', root)
    monkeypatch.setattr(jreg, 'MODELS', os.path.join(root, 'Models'))
    monkeypatch.setattr(jreg, 'TEXTURES', os.path.join(root, 'Textures'))
    monkeypatch.setenv('RT_ASSETS', root)


@pytest.fixture
def at_tree(tree, monkeypatch):
    point_at(monkeypatch, tree[0])
    return tree[0]


def test_names_hold_the_asset_scenes():
    names = registry.names()
    assert set(ASSET_SCENES) <= set(names)
    assert set(ASSET_SCENES) <= set(jreg.names())
    # the stand-ins stay beside them
    assert {'sponza_standin', 'final_forest_standin', 'triangle_sphere'} \
        <= set(names)


@pytest.mark.parametrize('name', ASSET_SCENES)
def test_signature_matches_jax(name):
    """The JAX builder's parameters and defaults, then builder= and
    device= (the card by default)."""
    want = inspect.signature(jreg._REGISTRY[name]).parameters
    got = dict(inspect.signature(registry.get(name)).parameters)
    assert got.pop('builder').default is None
    assert got.pop('device').default.type == 'cuda'
    assert list(got) == list(want)
    for k, p in want.items():
        assert got[k].kind == p.kind and got[k].default == p.default, k


def test_tree_layout(tree):
    """Every file in the reference's layout, small, in its format."""
    root, written = tree
    assert len(written) == len(set(written)) == 60
    dirs = {os.path.dirname(p) for p in written}
    assert dirs == {'Models', 'Models/CornellBox', 'Models/Final',
                    'Textures', 'Images'}
    for rel in written:
        path = os.path.join(root, rel)
        with open(path, 'rb') as f:
            head = f.read(18)
        if rel.endswith('.tga'):
            assert head[2] == 2 and head[1] == 0        # uncompressed RGB
            img, kind = tio.load_tga(path)
            assert max(img.shape[:2]) <= 256
            rgba = rel.rsplit('/', 1)[1] in (
                'Tree_03_Leaves.tga', 'AL04aut.tga', 'AL17aut.tga',
                'FL30lef1.tga', 'FL30lef2.tga')
            assert (kind == tio.RGBA) == rgba and head[16] == (32 if rgba
                                                               else 24)
        elif rel.endswith('.hdr'):
            assert head.startswith(b'#?RADIANCE')
        else:
            assert rel.endswith('.obj')
            text = open(path).read().split('\n')
            tags = {line.split(' ', 1)[0] for line in text if line}
            assert {'v', 'vn', 'f'} <= tags <= {'v', 'vn', 'vt', 'f'}


@pytest.mark.parametrize('kind', ['obj', 'tga', 'hdr'])
def test_files_read_back_alike(tree, kind):
    """Each written file through both packages' loaders: identical arrays;
    the meshes as generated, the images within their 8-bit (TGA) or RGBE
    (HDR) steps of the generated ones."""
    root, written = tree
    made = {**assets._models(), **assets._images()}
    files = [p for p in written if p.endswith('.' + kind)]
    assert files
    for rel in files:
        path = os.path.join(root, rel)
        if kind == 'obj':
            got, want = tobj.load_obj(path), jobj.load_obj(path)
            for f in ('vertices', 'normals', 'texcoords', 'face_v', 'face_n',
                      'face_t'):
                a, b = getattr(got, f), getattr(want, f)
                assert (a is None) == (b is None), (rel, f)
                if a is not None:
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                        (rel, f)
            m = made[rel]
            np.testing.assert_array_equal(got.vertices, m.vertices, rel)
            np.testing.assert_array_equal(got.face_v, m.face_v, rel)
            assert (got.texcoords is None) == (m.texcoords is None), rel
            continue
        (got, tg), (want, tw) = tio.load_image(path), jio.load_image(path)
        assert tg == tw and got.dtype == want.dtype == np.float32, rel
        assert got.tobytes() == want.tobytes(), rel
        src = made[rel]
        if kind == 'tga':
            # the nearest byte of the gamma-encoded value, read back
            # through the loader's 15-bit linear table: within a byte
            enc = lambda x: np.clip(x, 0, 1) ** (1 / 2.2)
            np.testing.assert_allclose(enc(got[..., :3]), enc(src[..., :3]),
                                       atol=1 / 255, err_msg=rel)
            np.testing.assert_array_equal(got[..., 3:], src[..., 3:], rel)
        else:
            # RGBE: 8 bits of mantissa of the largest channel
            step = src.max(-1, keepdims=True) / 128
            assert (np.abs(got - src) <= step + 1e-30).all(), rel


@pytest.mark.parametrize('case', sorted(BUILDS))
def test_build_matches_jax(at_tree, case):
    name = case.replace('_stone', '').replace('_hd', '').replace('_flat', '')
    kw = BUILDS[case]
    sj, cam_j, st_j = jreg.make(name, **kw)
    sp, cam, st = registry.make(name, device='cpu', **kw)
    aj, static_j = scene_arrays(sj)
    ap, static_p = convert.scene_to_arrays(sp)
    assert static_p == static_j
    assert set(aj) - set(ap) == {'materials.kt'} and set(ap) <= set(aj)
    for k, v in ap.items():
        assert v.dtype == aj[k].dtype and v.shape == aj[k].shape, k
        assert v.tobytes() == aj[k].tobytes(), k
    for f in dataclasses.fields(cam):
        a = getattr(cam, f.name)
        assert isinstance(a, torch.Tensor) and a.device.type == 'cpu'
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(cam_j, f.name)),
                                      err_msg=f.name)
    for f in dataclasses.fields(st):
        assert getattr(st, f.name) == getattr(st_j, f.name), f.name
    # each branch shows in the scene
    two_level = name in ('instanced_teapots', 'instanced_grid') or (
        name == 'final_forest' and not kw.get('flatten'))
    assert sp.single_level != two_level
    assert (sp.blas is not None) == kw.get('bvh', True)
    if name in ('mb_bullet', 'final_forest'):
        assert sp.has_motion_blur
    if name in ('alpha_leaf', 'final_forest'):
        assert sp.has_alpha_maps


def test_sponza_proxy_hd_is_bench_size(at_tree):
    """bench.py's configuration, sponza_proxy(hd=True), at its defaults:
    300 teapots of the stand-in tree's 576 triangles, as many triangles as
    sponza_standin."""
    scene, cam, st = registry.sponza_proxy(hd=True, bvh=False, device='cpu')
    assert scene.num_tris == 174_724
    assert (st.width, st.height, st.max_bounces) == (1920, 1080, 10)
    assert st.path_trace and st.max_wavefront_steps == 12


@pytest.mark.parametrize('name', ASSET_SCENES)
def test_missing_tree_raises(name, tmp_path, monkeypatch):
    """On an empty tree every builder raises FileNotFoundError, naming the
    file and RT_ASSETS; none builds with a stand-in."""
    monkeypatch.setenv('RT_ASSETS', str(tmp_path))
    kw = dict(n=4) if name == 'instanced_grid' else {}
    with pytest.raises(FileNotFoundError, match='RT_ASSETS') as err:
        registry.make(name, device='cpu', **kw)
    assert str(tmp_path) in str(err.value)


def test_one_missing_file_raises(tree, tmp_path, monkeypatch):
    """A tree short of one file: the scenes that read it raise, naming
    it; the others build."""
    import shutil
    root = tmp_path / 'tree'
    shutil.copytree(tree[0], root)
    gone = root / 'Models' / 'Final' / 'flower01Pistils.obj'
    gone.unlink()
    monkeypatch.setenv('RT_ASSETS', str(root))
    with pytest.raises(FileNotFoundError, match='flower01Pistils.obj'):
        registry.final_forest(**FOREST, device='cpu')
    scene, _, _ = registry.mb_bullet(size=8, device='cpu')
    assert scene.num_tris > 0


def test_rt_assets_is_read_at_build(tree, monkeypatch):
    """The port reads RT_ASSETS when a scene is built, not at import."""
    monkeypatch.delenv('RT_ASSETS', raising=False)
    assert registry.asset_root() == os.path.join(
        os.path.expanduser('~'), 'reference')
    monkeypatch.setenv('RT_ASSETS', tree[0])
    assert registry.asset_root() == tree[0]
    assert registry.asset_path('Models', 'teapot.obj') == os.path.join(
        tree[0], 'Models', 'teapot.obj')


def test_cli_renders_an_asset_scene(at_tree, tmp_path, capsys):
    """`--list-scenes` lists the asset scenes; `--scene cornell_pt` renders
    with RT_ASSETS set, the image of the registry's scene at that key."""
    assert cli.main(['--list-scenes']) == 0
    listed = capsys.readouterr().out.split()
    assert set(ASSET_SCENES) <= set(listed)
    out = str(tmp_path / 'cornell.ppm')
    assert cli.main(['--scene', 'cornell_pt', '--size', '16', '--spp', '1',
                     '--bounces', '2', '--device', 'cpu', '--out', out]) == 0
    img, _ = tio.load_ppm(out)
    assert img.shape == (16, 16, 3) and img.mean() > 0
