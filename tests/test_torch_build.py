"""The port's host-side scene build against raytracer_tpu.SceneBuilder.

Both builders run the same native SAH cluster build on the same geometry,
so the cluster tables (flat, or instance and two-level for an instanced
scene, which both builders build with their BVH, and the motion-blurred
partition) must be byte-equal, and every scene array equal exactly: the
t = 1 pose tables, the texel pool, the dome's CDF tables and the BVH too.
convert.scene_from_arrays must carry a JAX-built scene across without a
change, and scene_to_arrays must invert it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracer_tpu as rj
from raytracer_tpu.core.types import Camera as JCamera
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.core.types import Camera
from raytracer_tpu_torch.scenes import registry

from .torch_port_util import cpu, scene_arrays, to_port

BUILDS = {
    'triangle_sphere': lambda b: cpu(registry.triangle_sphere, size=8,
                                     builder=b),
    'sponza_standin_12': lambda b: cpu(registry.sponza_standin,
        32, 24, max_bounces=3, n_spheres=12, builder=b),
    'instanced_teapots': lambda b: cpu(registry.instanced_teapots_standin,
        8, 8, builder=b, bvh=True),
    'forest_8': lambda b: cpu(registry.forest_standin,
        8, 8, n_trees=8, canopy=(30, 32), builder=b, bvh=True),
    'mb_bullet': lambda b: cpu(registry.mb_bullet_standin, 8, builder=b),
    'alpha_leaf': lambda b: cpu(registry.alpha_leaf_standin, 8, builder=b),
    'dome': lambda b: cpu(registry.dome_standin, 8, builder=b),
    'final_forest_2': lambda b: cpu(registry.final_forest_standin,
        8, 8, n_trees=2, n_flowers=4, grass_grid=3, builder=b, bvh=True),
}


@pytest.fixture(scope='module', params=sorted(BUILDS))
def pair(request):
    make = BUILDS[request.param]
    return make(rj.SceneBuilder())[0], make(None)[0]


def test_cluster_tables_byte_equal(pair):
    sj, st = pair
    assert st.single_level == sj.single_level
    names = ['clusters'] if st.single_level else ['iclusters']
    assert (st.mb_clusters is None) == (sj.mb_clusters is None)
    if st.mb_clusters is not None:
        names.append('mb_clusters')
    for name in names:
        tj, tt = getattr(sj, name), getattr(st, name)
        for f in dataclasses.fields(tt):
            b = getattr(tt, f.name)
            if not isinstance(b, torch.Tensor):
                assert b == getattr(tj, f.name), f.name
                continue
            a, b = np.asarray(getattr(tj, f.name)), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name


def test_scene_arrays_equal(pair):
    sj, st = pair
    aj, sj_static = scene_arrays(sj)
    at, st_static = convert.scene_to_arrays(st)
    assert st_static == sj_static
    for k, v in at.items():
        np.testing.assert_array_equal(v, aj[k], err_msg=k)
        assert v.dtype == aj[k].dtype, k


def test_convert_round_trip(pair):
    sj, _ = pair
    aj, static = scene_arrays(sj)
    sc = to_port(sj)
    at, st2 = convert.scene_to_arrays(sc)
    assert st2 == static
    for k, v in at.items():
        np.testing.assert_array_equal(v, aj[k], err_msg=k)
    again = cpu(convert.scene_from_arrays, at, st2)
    for k, v in convert.scene_to_arrays(again)[0].items():
        np.testing.assert_array_equal(v, at[k], err_msg=k)


def test_sponza_standin_size():
    """The full stand-in: 300 spheres of 576 triangles around the atrium."""
    scene, cam, st = cpu(registry.sponza_standin)
    assert scene.num_tris == 174_724
    assert scene.clusters.num_clusters == 2032
    assert (st.width, st.height, st.max_bounces) == (1920, 1080, 10)
    assert isinstance(scene.geom.vertices, torch.Tensor)


def test_unported_features_raise():
    """Image files, the BVH and motion-blurred prototypes build now (a
    motion-blurred prototype leaves the scene without cluster tables: it
    traces through its BVH, and without one 'auto' raises); a scene
    without its cluster table does not convert."""
    from raytracer_tpu_torch import SceneBuilder, RenderSettings
    from raytracer_tpu_torch.io.objload import make_single_triangle
    from raytracer_tpu_torch.render import integrator
    b = SceneBuilder()
    with pytest.raises(FileNotFoundError):
        b.add_texture_file('leaf.tga')
    tri = make_single_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    b.begin_prototype()
    b.add_mesh(tri, b.add_lambert(), mesh_t1=tri)
    b.add_instance(b.end_prototype(), np.eye(4))
    b.add_mesh(make_single_triangle((0, 0, 1), (1, 0, 1), (0, 1, 1)), 0)
    bare = cpu(b.build)
    assert bare.iclusters is None and bare.mb_clusters is None
    with pytest.raises(ValueError, match='bvh=True'):
        integrator.trace_fn(bare, RenderSettings())
    assert cpu(b.build, bvh=True).blas is not None
    sj, _, _ = cpu(registry.triangle_sphere, size=8,
                   builder=rj.SceneBuilder())
    arrays, static = scene_arrays(sj)
    arrays = {k: v for k, v in arrays.items() if not k.startswith('clusters')}
    with pytest.raises(ValueError, match='cluster'):
        cpu(convert.scene_from_arrays, arrays, static)


def test_texel_pool_and_dome_tables():
    """The texel pool and its descriptors, and the dome's CDF tables, as the
    JAX build makes them (byte-equal), moved to a device as one set."""
    sj, _, _ = cpu(registry.dome_standin, 8, builder=rj.SceneBuilder())
    st, _, _ = cpu(registry.dome_standin, 8)
    for group in ('textures', 'dome'):
        for f in dataclasses.fields(getattr(st, group)):
            got = getattr(getattr(st, group), f.name)
            want = getattr(getattr(sj, group), f.name)
            if isinstance(got, torch.Tensor):
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f.name
                assert got.numpy().tobytes() == want.tobytes(), f.name
            else:
                assert got == want, f.name
    assert st.textures.data.numel() > 0 and st.dome.num_samples == 4
    assert st.env_tex == st.dome.tex == 0
    moved = st.to('cpu')
    assert moved.dome.v_cdf.shape == (256, registry.DOME_ROWS + 1)


def test_static_t1_tables_alias():
    """A static table's t = 1 pose is its t = 0 pose, one buffer, and stays
    one buffer when the scene moves; a motion-blurred one has its own."""
    static, _, _ = cpu(registry.triangle_sphere, size=8)
    cl = static.clusters
    assert cl.p0_t1 is cl.p0 and cl.e2_t1 is cl.e2
    moved = static.to(torch.device('cpu')).clusters
    assert moved.p0_t1 is moved.p0
    mb, _, _ = cpu(registry.mb_bullet_standin, 8)
    assert mb.has_motion_blur and mb.clusters.p0_t1 is not mb.clusters.p0
    assert mb.clusters.nbytes > cl.nbytes


def test_camera_from_arrays():
    """A JAX Camera's leaves carried across equal the port's Camera.make."""
    kw = dict(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55.0, aperture=0.1,
              focus_plane=3.0)
    cj = JCamera.make(**kw)
    leaves = jax.tree_util.tree_flatten_with_path(cj)[0]
    arrays = {path[0].name: np.asarray(v) for path, v in leaves}
    got, want = cpu(convert.camera_from_arrays, arrays), Camera.make(**kw)
    for k in ('eye', 'view_dir', 'up', 'fov', 'focus_plane', 'aperture',
              'shutter'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy(), err_msg=k)


@pytest.mark.parametrize('entry', ['registry', 'builder', 'convert',
                                   'camera', 'params', 'stone', 'bvh',
                                   'graft_entry'])
def test_builders_default_to_the_card(entry):
    """Scenes, cameras, parameters and baked textures land on the card
    unless the caller names another device; without a card the default
    raises (it never builds on the CPU quietly), and device='cpu' builds
    there."""
    from raytracer_tpu_torch import SceneBuilder, graft_entry
    from raytracer_tpu_torch.io.objload import make_single_triangle
    from raytracer_tpu_torch.shading import procedural
    sj, _, _ = cpu(registry.triangle_sphere, size=8,
                   builder=rj.SceneBuilder())
    arrays, static = scene_arrays(sj)
    cam_arrays = {k: np.asarray(v) for k, v in
                  dataclasses.asdict(JCamera.make(eye=(0, 1, 2),
                                                  look_at=(0, 0, 0))).items()}

    def builder(**kw):
        b = SceneBuilder()
        b.add_mesh(make_single_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0)),
                   b.add_lambert())
        return b.build(**kw)

    make = dict(
        registry=lambda **kw: registry.triangle_sphere(size=8, **kw)[0],
        builder=builder,
        convert=lambda **kw: convert.scene_from_arrays(arrays, static, **kw),
        camera=lambda **kw: convert.camera_from_arrays(cam_arrays, **kw),
        params=lambda **kw: convert.params_from_arrays(
            {k: np.zeros(2, np.float32) for k in convert.PARAM_KEYS},
            **kw),
        stone=lambda **kw: procedural.bake_stone_texture(num_cells=4,
                                                         size=4, **kw),
        bvh=lambda **kw: registry.triangle_sphere(size=8, bvh=True,
                                                  **kw)[0],
        graft_entry=lambda **kw: graft_entry.entry(**kw)[1][0])[entry]
    if torch.cuda.is_available():
        assert _devices(make()) == {'cuda'}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert _devices(make(device='cpu')) == {'cpu'}


def _devices(x):
    """Device types of a params dict, a Scene, a Camera or a tensor."""
    if isinstance(x, dict):
        vals = list(x.values())
    elif isinstance(x, torch.Tensor):
        vals = [x]
    elif hasattr(x, 'geom'):
        vals = [x.geom.vertices, x.materials.kd, x.env_exposure,
                x.clusters.p0, x.clusters.tri]
        if x.blas is not None:
            vals += [x.blas.node_min, x.blas.prim_order, x.instances.root]
    else:
        vals = [x.eye, x.fov]
    return {v.device.type for v in vals}
