"""The port's OBJ loader against the JAX package's, and image textures.

Each OBJ file is written by the test: v/vt/vn records with v, v/t, v//n
and v/t/n corners, negative (relative) indices, quads and n-gons
(fan-triangulated), a file without normals (face normals generated) and a
load under a CTM. The port's native parser (native/rt_native.cpp) is held
to the JAX package's native parser, and its Python parser to the JAX
package's Python parser (reached by making its native parse return None):
every array equal. add_texture_file must add what add_texture(load_image)
adds.
"""
import dataclasses

import numpy as np
import pytest

from raytracer_tpu import native as jnative
from raytracer_tpu.io import objload as jobj
from raytracer_tpu_torch import SceneBuilder
from raytracer_tpu_torch.io import imageio, objload as tobj

from .test_torch_imageio import _tga_bytes


def _obj_text(rs, with_vt=True, with_vn=True) -> str:
    """A small random mesh: 9 vertices, triangles, a quad and a pentagon,
    some corners by negative index."""
    lines = ['# written by the test', 'o mesh']
    v = rs.uniform(-2, 2, (9, 3))
    lines += ['v %.9g %.9g %.9g' % tuple(p) for p in v]
    if with_vt:
        lines += ['vt %.9g %.9g' % tuple(p) for p in rs.uniform(0, 1, (9, 2))]
    if with_vn:
        n = rs.normal(size=(9, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        lines += ['vn %.9g %.9g %.9g' % tuple(p) for p in n]

    def corner(i):
        # 1-based ids, every third by negative index (relative to 9)
        k = i + 1 if i % 3 else i - 9
        if with_vt and with_vn:
            return f'{k}/{k}/{k}'
        if with_vn:
            return f'{k}//{k}'
        if with_vt:
            return f'{k}/{k}'
        return f'{k}'
    faces = [(0, 1, 2), (2, 3, 4), (0, 4, 5, 6), (1, 3, 5, 7, 8),
             (8, 6, 4)]
    lines += ['f ' + ' '.join(corner(i) for i in f) for f in faces]
    lines.append('s off')
    return '\n'.join(lines) + '\n'


CASES = {'v_vt_vn': dict(), 'v_vn': dict(with_vt=False),
         'v_vt': dict(with_vn=False), 'v': dict(with_vt=False,
                                                with_vn=False)}
CTM = np.array([[0.0, -2.0, 0.0, 1.0], [1.5, 0.0, 0.0, -2.0],
                [0.0, 0.0, 0.5, 3.0]], np.float32)


def _assert_meshes_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize('ctm', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_load_obj_equal(tmp_path, monkeypatch, case, ctm):
    rs = np.random.default_rng(sorted(CASES).index(case))
    path = str(tmp_path / f'{case}.obj')
    with open(path, 'w') as f:
        f.write(_obj_text(rs, **CASES[case]))
    m = CTM if ctm else None
    native = tobj.load_obj(path, ctm=m)
    assert native.num_tris == 1 + 1 + 2 + 3 + 1
    _assert_meshes_equal(native, jobj.load_obj(path, ctm=m))
    # the Python parsers: the JAX package's, its native parse made to
    # return None
    monkeypatch.setattr(jnative, 'parse_obj_native', lambda p: None)
    want = jobj.load_obj(path, ctm=m)
    _assert_meshes_equal(tobj._load_obj_python(path, m), want)
    _assert_meshes_equal(native, want)


def test_load_obj_parser_and_errors(tmp_path):
    with pytest.raises(OSError):
        tobj.load_obj(str(tmp_path / 'missing.obj'))


def test_transform_mesh_equal(tmp_path):
    path = str(tmp_path / 'mesh.obj')
    with open(path, 'w') as f:
        f.write(_obj_text(np.random.default_rng(5)))
    mesh_t, mesh_j = tobj.load_obj(path), jobj.load_obj(path)
    tobj.compute_tangents(mesh_t)
    jobj.compute_tangents(mesh_j)
    _assert_meshes_equal(tobj.transform_mesh(mesh_t, CTM),
                         jobj.transform_mesh(mesh_j, CTM))


def test_add_texture_file(tmp_path):
    """A TGA and an HDR texture through add_texture_file, as
    add_texture(load_image(...)) adds them."""
    rs = np.random.default_rng(9)
    tga = str(tmp_path / 'leaf.tga')
    with open(tga, 'wb') as f:
        f.write(_tga_bytes(rs.integers(0, 256, (5, 6, 4), dtype=np.uint8),
                           2, False))
    hdr = str(tmp_path / 'sky.hdr')
    with open(hdr, 'wb') as f:
        f.write(b'#?RADIANCE\n\n-Y 2 +X 3\n'
                + rs.integers(1, 200, (2, 3, 4), dtype=np.uint8).tobytes())
    a, b = SceneBuilder(), SceneBuilder()
    for path in (tga, hdr):
        assert a.add_texture_file(path) == \
            b.add_texture(imageio.load_image(path)[0])
    assert len(a._tex_imgs) == 2
    for x, y in zip(a._tex_imgs, b._tex_imgs):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
