"""Named scene fixtures that need no asset files.

Each builder returns (Scene, Camera, RenderSettings), as in
raytracer_tpu/scenes/registry.py. `builder=` takes any object with the
SceneBuilder interface, so a test can pass `raytracer_tpu.SceneBuilder()`
and have the JAX package build the very same scene (instanced scenes then
take `bvh=True`, which the JAX builder needs and this package's refuses).
"""
from __future__ import annotations

import numpy as np

from ..core import transforms as tf
from ..core.types import Camera, RenderSettings
from ..geometry.build import SceneBuilder
from ..geometry import shapes
from ..io.objload import MeshData, make_single_triangle

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make(name, **kwargs):
    return _REGISTRY[name](**kwargs)


@register('triangle_sphere')
def triangle_sphere(size=256, builder=None, **kw):
    """Single triangle + sphere + point light, Lambert (the JAX registry's
    `triangle_sphere`, BASELINE config #1)."""
    b = SceneBuilder() if builder is None else builder
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.add_mesh(make_single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10),
                                    n=(0, 1, 0)), lam)
    b.add_mesh(shapes.uv_sphere((0, 1, 0), 1.0, 12, 24, with_uv=False), lam)
    b.add_point_light((10, 10, 10), 700.0)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = b.build(bvh=False)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0)
    settings = RenderSettings(width=size, height=size, path_trace=False,
                              max_bounces=5, max_wavefront_steps=2, **kw)
    return scene, cam, settings


# the rect light's plane; the emitter quad sits this far below it, closer
# than the shadow rays' EPSILON stand-off, so it never occludes the light
RECT_Y = 10.0
QUAD_DROP = 1e-5


@register('sponza_standin')
def sponza_standin(width=1920, height=1080, max_bounces=10, rect_samples=1,
                   ray_tile=8 * 128, n_spheres=300, builder=None, **kw):
    """The JAX registry's `sponza_proxy(hd=True)` built from procedural
    shapes alone: the same shell, two colonnade stories, gallery slabs,
    balustrades, camera, rect light and clutter RNG (seed 3163513).

    Two substitutions, because the asset files are not shipped: the light
    quad of `sponza-light.obj` becomes a `shapes.quad` of the emitter
    material just below the rect light, and each teapot becomes a
    576-triangle `uv_sphere(center, r, 13, 24)` (the teapot's count) with
    r = the teapot's random scale, resting on the floor or, for one in
    three, on the gallery. With 300 spheres: 174,724 triangles."""
    b = SceneBuilder() if builder is None else builder
    white = b.add_blinn(kd=(1, 1, 1))
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=1.5, le=(1, 1, 1))
    y = RECT_Y - QUAD_DROP
    b.add_mesh(shapes.quad((-8, y, -2), (8, y, -2), (8, y, 2), (-8, y, 2),
                           with_uv=False), lmat)      # facing down
    # atrium shell
    b.add_mesh(shapes.quad((-10, 0, -5), (10, 0, -5), (10, 0, 5), (-10, 0, 5),
                           with_uv=False), white)
    b.add_mesh(shapes.box((-10, 0, -5.2), (10, 8, -5.0)), white)
    b.add_mesh(shapes.box((-10, 0, 5.0), (10, 8, 5.2)), white)
    b.add_mesh(shapes.box((-10.2, 0, -5.2), (-10.0, 8, 5.2)), white)
    b.add_mesh(shapes.box((10.0, 0, -5.2), (10.2, 8, 5.2)), white)
    # ground-floor colonnade
    for i in range(12):
        x = -9 + i * 1.64
        for z in (-3.5, 3.5):
            b.add_mesh(shapes.cylinder((x, 0, z), 0.3, 5.0, n_seg=16), white)
    # second-story gallery: side slabs around the central opening, upper
    # colonnade and balustrade blocks between the upper columns
    for z0, z1 in ((-5.0, -2.5), (2.5, 5.0)):
        b.add_mesh(shapes.box((-10, 4.8, z0), (10, 5.0, z1)), white)
    for x0, x1 in ((-10.0, -8.5), (8.5, 10.0)):
        b.add_mesh(shapes.box((x0, 4.8, -2.5), (x1, 5.0, 2.5)), white)
    for i in range(12):
        x = -9 + i * 1.64
        for z in (-3.0, 3.0):
            b.add_mesh(shapes.cylinder((x, 5.0, z), 0.25, 3.0, n_seg=16),
                       white)
            b.add_mesh(shapes.box((x - 0.7, 5.0, z - 0.08),
                                  (x + 0.7, 5.6, z + 0.08)), white)
    # clutter, drawn in the same RNG order as sponza_proxy's teapots
    rng = np.random.default_rng(3163513)
    for k in range(n_spheres):
        r = rng.uniform(0.2, 0.5)
        if k % 3 == 0:
            c = (rng.uniform(-9, 9), 5.0 + r, rng.uniform(-4.6, -2.8))
        else:
            c = (rng.uniform(-9, 9), r, rng.uniform(-4, 4))
        b.add_mesh(shapes.uv_sphere(c, r, 13, 24, with_uv=False), white)
    b.add_rect_light((8.0, RECT_Y, 2), (8.0, RECT_Y, -2.0), (-8, RECT_Y, 2),
                     power=1.5, num_samples=rect_samples)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = b.build(bvh=False)
    cam = Camera.make(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55.0)
    settings = RenderSettings(width=width, height=height, path_trace=True,
                              max_bounces=max_bounces,
                              max_wavefront_steps=max_bounces + 2,
                              ray_tile=ray_tile, **kw)
    return scene, cam, settings


def _teapot_sphere() -> MeshData:
    """The 576-triangle stand-in for teapot.obj (as in sponza_standin): a
    unit sphere resting on y = 0."""
    return shapes.uv_sphere((0.0, 1.0, 0.0), 1.0, 13, 24, with_uv=False)


@register('instanced_teapots_standin')
def instanced_teapots_standin(width=256, height=256, grid=4, builder=None,
                              bvh=False, **kw):
    """The JAX registry's `instanced_teapots` without asset files: the
    same grid x grid layout, rotations and scales (rng seed 3163513),
    floor, light and camera, with `_teapot_sphere` as the prototype."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.8, 0.5, 0.3), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(_teapot_sphere(), mat)
    proto = b.end_prototype()
    rng = np.random.default_rng(3163513)
    for i in range(grid):
        for j in range(grid):
            ang = rng.uniform(0, 2 * np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            s = rng.uniform(0.6, 1.2)
            m = np.asarray([[s * ca, 0, s * sa, (i - grid / 2) * 3.0],
                            [0, s, 0, 0],
                            [-s * sa, 0, s * ca, (j - grid / 2) * 3.0]],
                           np.float32)
            b.add_instance(proto, m)
    floor = b.add_lambert(kd=(0.7, 0.7, 0.7))
    b.add_mesh(make_single_triangle((-60, 0, -60), (0, 0, 60), (60, 0, -60),
                                    n=(0, 1, 0)), floor)
    b.add_point_light((20, 30, 20), 5000.0)
    b.set_bg_color((0.05, 0.05, 0.1))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, 8, grid * 2.5 + 6), look_at=(0, 0.5, 0),
                      fov=45.0)
    settings = RenderSettings(width=width, height=height, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


@register('instanced_grid_standin')
def instanced_grid_standin(width=256, height=256, n=100_000, spacing=2.0,
                           builder=None, bvh=False, **kw):
    """The JAX registry's `instanced_grid` without asset files: n
    instances on the same jittered grid with the same rotations, scales,
    light, camera and settings, with `_teapot_sphere` as the prototype
    (5 clusters, 2 segments per instance)."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.75, 0.55, 0.35), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(_teapot_sphere(), mat)
    proto = b.end_prototype()
    g = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(3163513)
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing='ij')
    ii = ii.reshape(-1)[:n]
    jj = jj.reshape(-1)[:n]
    ang = rng.uniform(0, 2 * np.pi, n)
    sc = rng.uniform(0.5, 1.0, n).astype(np.float32)
    jit = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    ca, sa = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    tx = ((ii - g / 2) * spacing + jit[:, 0]).astype(np.float32)
    tz = ((jj - g / 2) * spacing + jit[:, 1]).astype(np.float32)
    ms = np.zeros((n, 3, 4), np.float32)
    ms[:, 0, 0] = sc * ca
    ms[:, 0, 2] = sc * sa
    ms[:, 1, 1] = sc
    ms[:, 2, 0] = -sc * sa
    ms[:, 2, 2] = sc * ca
    ms[:, 0, 3] = tx
    ms[:, 2, 3] = tz
    for k in range(n):
        b.add_instance(proto, ms[k])
    b.add_point_light((0, g * spacing, 0), float(g * spacing) ** 2 * 2.0)
    b.set_bg_color((0.05, 0.05, 0.1))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0, g * spacing * 0.12, g * spacing * 0.55),
                      look_at=(0, 0.0, 0), fov=50.0)
    settings = RenderSettings(width=width, height=height, path_trace=False,
                              max_wavefront_steps=2, **kw)
    return scene, cam, settings


def procedural_trunk(height=1.2, radius=0.05) -> MeshData:
    """A tapered trunk of three stacked cylinders (the JAX registry's
    `_procedural_trunk`, its stand-in for the unshipped Tree0*Body.obj)."""
    parts = []
    h0 = 0.0
    r = radius
    for seg in range(3):
        h = height * (0.5 if seg == 0 else 0.3 if seg == 1 else 0.2)
        parts.append(shapes.cylinder((0.0, h0, 0.0), r, h, n_seg=8))
        h0 += h
        r *= 0.65
    verts = np.concatenate([p.vertices for p in parts])
    norms = np.concatenate([p.normals for p in parts])
    nv = np.cumsum([0] + [len(p.vertices) for p in parts[:-1]])
    nn = np.cumsum([0] + [len(p.normals) for p in parts[:-1]])
    fv = np.concatenate([p.face_v + nv[i] for i, p in enumerate(parts)])
    fn = np.concatenate([p.face_n + nn[i] for i, p in enumerate(parts)])
    return MeshData(vertices=verts.astype(np.float32),
                    normals=norms.astype(np.float32), texcoords=None,
                    face_v=fv.astype(np.int32), face_n=fn.astype(np.int32),
                    face_t=None)


@register('forest_standin')
def forest_standin(width=256, height=256, n_trees=200, canopy=(60, 64),
                   builder=None, bvh=False, **kw):
    """An instanced forest without asset files, in the manner of the JAX
    registry's `final_forest`: two tree prototypes, each a procedural
    trunk under an opaque sphere canopy (canopy=(60, 64): 7,552 triangles,
    so a prototype spans more than 16 clusters and takes the hierarchical
    instance tracer), placed n_trees times (alternating prototypes, random
    position, scale and yaw from rng seed 3163513) on a 24 x 32 m patch in
    front of the camera; a ground quad as world geometry and one point
    light. No textures, alpha cutouts, translucency or dome (ROADMAP queue
    1 #11)."""
    b = SceneBuilder() if builder is None else builder
    bark = b.add_blinn(kd=(0.35, 0.25, 0.15), spec_amt=0.1, spec_exp=10.0)
    leaves = b.add_blinn(kd=(0.2, 0.5, 0.15), spec_amt=0.2, spec_exp=20.0)
    ground = b.add_lambert(kd=(0.4, 0.35, 0.25))
    n_lat, n_lon = canopy
    protos = []
    for trunk_h, trunk_r, crown_r in ((1.2, 0.05, 0.5), (1.5, 0.06, 0.6)):
        b.begin_prototype()
        b.add_mesh(procedural_trunk(trunk_h, trunk_r), bark)
        b.add_mesh(shapes.uv_sphere((0.0, trunk_h + 0.6 * crown_r, 0.0),
                                    crown_r, n_lat, n_lon, with_uv=False),
                   leaves)
        protos.append(b.end_prototype())
    rng = np.random.default_rng(3163513)
    placed = 0
    while placed < n_trees:
        x, z = rng.uniform(-12.0, 12.0), rng.uniform(-30.0, 2.0)
        if abs(x) < 1.0 and z > -3.0:
            continue                      # a clearing in front of the camera
        s = rng.uniform(0.85, 1.15)
        m = tf.translate(x, 0.0, z) @ tf.scale(s) \
            @ tf.rotate_y(rng.uniform(0.0, 360.0))
        b.add_instance(protos[placed % 2], m)
        placed += 1
    b.add_mesh(shapes.quad((-40, 0, -40), (-40, 0, 40), (40, 0, 40),
                           (40, 0, -40), with_uv=False), ground)
    b.add_point_light((10.0, 30.0, 10.0), 15000.0)
    b.set_bg_color((0.4, 0.5, 0.7))
    scene = b.build(bvh=bvh)
    cam = Camera.make(eye=(0.0, 1.0, 6.0), look_at=(0.0, 1.2, 0.0), fov=50.0)
    settings = RenderSettings(width=width, height=height, path_trace=False,
                              max_bounces=5, max_wavefront_steps=7, **kw)
    return scene, cam, settings
