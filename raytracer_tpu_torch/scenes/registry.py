"""Named scene fixtures.

Each builder returns (Scene, Camera, RenderSettings), as in
raytracer_tpu/scenes/registry.py. Two kinds:

* the JAX registry's asset scenes under its names (`cornell_pt`,
  `sponza_proxy`, `final_forest`, ...), line for line: the same
  parameters and defaults, seeds, draw order, cameras and settings. They
  read the reference checkout's Models/, Textures/ and Images/ under the
  tree that RT_ASSETS names (default ~/reference). One difference: the
  JAX registry reads RT_ASSETS when it is imported, this one when a scene
  is built (`asset_root`). A missing file raises FileNotFoundError
  (`asset_path`); no builder puts a stand-in in its place.
  `scenes/assets.write_tree` writes a stand-in tree of every file they
  read;
* `*_standin` fixtures and `triangle_sphere`, which need no asset files.

`builder=` takes any object with the SceneBuilder interface, so a test
can pass `raytracer_tpu.SceneBuilder()` and have the JAX package build the
very same scene (instanced scenes then take `bvh=True`, which the JAX
builder needs). Every builder takes `bvh=` (default False for the
stand-ins, but for `mb_prototype_standin`, which only the BVH traces; the
asset scenes keep the JAX registry's defaults): True adds the merged BVH
that intersector='bvh' traces. `device=` (default: the card) is where the
scene and camera land; a foreign builder's scene comes back as that
builder made it. The settings' ray tile is `frame_tile`'s for the device
unless one is given.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import transforms as tf
from ..core.types import CUDA, Camera, RenderSettings, device_of
from ..geometry.build import SceneBuilder
from ..geometry import shapes
from ..io.objload import (MeshData, compute_tangents, load_obj,
                          make_single_triangle, transform_mesh)
from . import assets

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def names():
    return sorted(_REGISTRY)


def get(name):
    """The registered function that builds scene `name`."""
    return _REGISTRY[name]


def make(name, **kwargs):
    return get(name)(**kwargs)


def _build(b, bvh, device):
    """The builder's scene: on `device` from this package's builder."""
    if isinstance(b, SceneBuilder):
        return b.build(bvh=bvh, device=device)
    return b.build(bvh=bvh)


def _on(cam, device):
    return cam.to(device_of(device))


# the largest ray tile a frame renders in on the card
FRAME_TILE = 1 << 21


def frame_tile(width, height, device) -> int:
    """The ray tile of a width x height frame on `device`: RenderSettings'
    1,024 rays (the JAX package's) on the CPU; on the card the whole frame,
    rounded up to 1,024 rays, up to FRAME_TILE. Eager PyTorch launches a
    bounce's few hundred kernels whatever the tile, so the card renders
    the 1080p atrium frame in one tile in 0.78 s, against 1.14 s at 2**19
    rays and 3.71 s at 2**17 (scripts/torch_frame_profile.py on an H100
    80GB HBM3 at 700 W); in 1,024-ray tiles it would take minutes."""
    if torch.device(device).type != 'cuda':
        return RenderSettings.ray_tile
    R = width * height
    return min(R + (-R) % 1024, FRAME_TILE)


def _settings(device, **fields) -> RenderSettings:
    """A scene's RenderSettings on `device`: the ray tile, unless given,
    is frame_tile's."""
    if fields.get('ray_tile') is None:
        fields['ray_tile'] = frame_tile(fields['width'], fields['height'],
                                        device)
    return RenderSettings(**fields)


@register('triangle_sphere')
def triangle_sphere(size=256, builder=None, bvh=False, device=CUDA, **kw):
    """Single triangle + sphere + point light, Lambert (the JAX registry's
    `triangle_sphere`, BASELINE config #1)."""
    b = SceneBuilder() if builder is None else builder
    lam = b.add_lambert(kd=(1.0, 1.0, 1.0))
    b.add_mesh(make_single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10),
                                    n=(0, 1, 0)), lam)
    b.add_mesh(shapes.uv_sphere((0, 1, 0), 1.0, 12, 24, with_uv=False), lam)
    b.add_point_light((10, 10, 10), 700.0)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0)
    settings = _settings(
        device, width=size, height=size, path_trace=False, max_bounces=5,
        max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


# the rect light's plane; the emitter quad sits this far below it, closer
# than the shadow rays' EPSILON stand-off, so it never occludes the light
RECT_Y = 10.0
QUAD_DROP = 1e-5


@register('sponza_standin')
def sponza_standin(width=1920, height=1080, max_bounces=10, rect_samples=1,
                   ray_tile=None, n_spheres=300, builder=None,
                   bvh=False, device=CUDA, **kw):
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
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55.0)
    settings = _settings(
        device, width=width, height=height, path_trace=True,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2,
        ray_tile=ray_tile, **kw)
    return scene, _on(cam, device), settings


def _teapot_sphere() -> MeshData:
    """The 576-triangle stand-in for teapot.obj (as in sponza_standin): a
    unit sphere resting on y = 0."""
    return shapes.uv_sphere((0.0, 1.0, 0.0), 1.0, 13, 24, with_uv=False)


@register('instanced_teapots_standin')
def instanced_teapots_standin(width=256, height=256, grid=4, builder=None,
                              bvh=False, device=CUDA, **kw):
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
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 8, grid * 2.5 + 6), look_at=(0, 0.5, 0),
                      fov=45.0)
    settings = _settings(
        device, width=width, height=height, path_trace=False,
        max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('instanced_grid_standin')
def instanced_grid_standin(width=256, height=256, n=100_000, spacing=2.0,
                           builder=None, bvh=False, device=CUDA, **kw):
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
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, g * spacing * 0.12, g * spacing * 0.55),
                      look_at=(0, 0.0, 0), fov=50.0)
    settings = _settings(
        device, width=width, height=height, path_trace=False,
        max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


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
    return assets.merged(parts)


@register('forest_standin')
def forest_standin(width=256, height=256, n_trees=200, canopy=(60, 64),
                   builder=None, bvh=False, device=CUDA, **kw):
    """An instanced forest without asset files, in the manner of the JAX
    registry's `final_forest`: two tree prototypes, each a procedural
    trunk under an opaque sphere canopy (canopy=(60, 64): 7,552 triangles,
    so a prototype spans more than 16 clusters and takes the hierarchical
    instance tracer), placed n_trees times (alternating prototypes, random
    position, scale and yaw from rng seed 3163513) on a 24 x 32 m patch in
    front of the camera; a ground quad as world geometry and one point
    light. No textures, alpha cutouts, translucency or dome: those are in
    `final_forest_standin`."""
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
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0.0, 1.0, 6.0), look_at=(0.0, 1.2, 0.0), fov=50.0)
    settings = _settings(
        device, width=width, height=height, path_trace=False, max_bounces=5,
        max_wavefront_steps=7, **kw)
    return scene, _on(cam, device), settings


@register('mb_bullet_standin')
def mb_bullet_standin(size=256, shutter=1.0, builder=None, bvh=False,
                      device=CUDA, **kw):
    """The JAX registry's `mb_bullet` (the motion-blur fixture) without its
    mesh pair: a shattered sphere (`assets.shattered_sphere`, 224 shards of
    radius 1) whose t = 1 pose pushes every shard 0.3-0.9 outward stands in
    for bulletMB_01/02.obj. The same material, floor, light, background,
    camera rule and 1.0 shutter."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.8, 0.7, 0.2), spec_amt=0.4, spec_exp=15.0)
    m0, m1 = assets.shattered_sphere((0.0, 0.0, 0.0), 1.0, 8, 16, 0.6, 11)
    b.add_mesh(m0, mat, mesh_t1=m1)
    floor = b.add_lambert(kd=(0.7, 0.7, 0.7))
    b.add_mesh(make_single_triangle((-20, -2, -20), (0, -2, 20), (20, -2, -20),
                                    n=(0, 1, 0)), floor)
    b.add_point_light((5, 10, 5), 500.0)
    b.set_bg_color((0.1, 0.1, 0.15))
    scene = _build(b, bvh, device)
    lo = m0.vertices.min(0)
    hi = m0.vertices.max(0)
    c = 0.5 * (lo + hi)
    cam = Camera.make(eye=c + np.asarray([0, 0.5, 3.5]) * (hi - lo).max(),
                      look_at=c, fov=45.0, shutter=shutter)
    settings = _settings(
        device, width=size, height=size, path_trace=False,
        max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('mb_prototype_standin')
def mb_prototype_standin(size=256, grid=4, rings=12, segs=24, builder=None,
                         bvh=True, device=CUDA, **kw):
    """A two-level scene whose prototype is motion-blurred: a sphere of
    rings x segs that moves up over the 1.0 shutter, placed grid x grid
    times over a floor, each placement 5% larger than the last. No JAX
    registry scene is like it. It has no cluster tables, so only the BVH
    traces it ('auto' takes 'bvh'), and bvh defaults to True here."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_lambert(kd=(0.7, 0.6, 0.5))
    h = 2.0 * grid
    b.add_mesh(shapes.quad((-h, 0, -h), (h, 0, -h), (h, 0, h), (-h, 0, h),
                           with_uv=False), mat)
    b.begin_prototype()
    b.add_mesh(shapes.uv_sphere((0, 0.6, 0), 0.5, rings, segs, with_uv=False),
               mat, mesh_t1=shapes.uv_sphere((0, 1.4, 0), 0.5, rings, segs,
                                             with_uv=False))
    proto = b.end_prototype()
    for i in range(grid * grid):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 1.0 + 0.05 * i
        m[0, 3] = 4.0 * (i % grid) - 2.0 * (grid - 1)
        m[2, 3] = 4.0 * (i // grid) - 2.0 * (grid - 1)
        b.add_instance(proto, m)
    b.add_point_light((3, 6, 4), 300.0)
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 0.75 * h, 1.5 * h), look_at=(0, 0, 0),
                      fov=50.0, shutter=1.0)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('alpha_leaf_standin')
def alpha_leaf_standin(size=256, max_bounces=5, builder=None, bvh=False,
                       device=CUDA, **kw):
    """The JAX registry's `alpha_leaf` (makeAlphaTest) without its files:
    two leaf cards (a 2 x 2 quad each, for leaf_test.obj) moved as there,
    with a procedural RGBA leaf (`assets.leaf_texture`) as both colour and
    alpha map (for Tree_03_Leaves.tga), translucency 0.9, the point light
    from below and behind, a procedural HDR sky as the env map (for
    Topanga_Forest_B_light.hdr), the same camera, path traced."""
    b = SceneBuilder() if builder is None else builder
    leaf_tex = b.add_texture(assets.leaf_texture(128, seed=3))
    env = b.add_texture(assets.sky_hdr(64, 128, sun_power=40.0))
    leaf2 = b.add_blinn(kd=(1, 1, 1), translucency=0.9,
                        tex_color=leaf_tex, tex_alpha=leaf_tex)
    for x, y in ((-2.0, 0.0), (-1.0, 0.5)):
        b.add_mesh(shapes.quad((x - 1, y - 1, 0), (x + 1, y - 1, 0),
                               (x + 1, y + 1, 0), (x - 1, y + 1, 0)), leaf2)
    b.add_point_light((-10, -10, -10), 4000.0)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0,
                      aperture=0.001, focus_plane=4.0)
    settings = _settings(
        device, width=size, height=size, path_trace=True,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings


# rows of the procedural dome skies (odd: see assets.DOME_ROWS)
DOME_ROWS = assets.DOME_ROWS


@register('dome_standin')
def dome_standin(size=256, dome_samples=4, builder=None, bvh=False,
                 device=CUDA, **kw):
    """The JAX registry's `dome_teapot` without its files: a procedural
    lat-long HDR sky with a sun spot (`assets.sky_hdr`, for sky.hdr) as both
    dome light and env map, a procedural grass texture on the same ground
    quad, and a 576-triangle sphere for the teapot. The same materials,
    dome gain and samples, camera and settings. The sky has an odd number
    of rows (DOME_ROWS)."""
    b = SceneBuilder() if builder is None else builder
    sky = b.add_texture(assets.sky_hdr(DOME_ROWS, 256))
    grass = b.add_texture(assets.solid_texture((0.2, 0.45, 0.1), 64,
                                               grain=0.4, seed=5))
    gmat = b.add_blinn(kd=(1, 1, 1), tex_color=grass)
    b.add_mesh(shapes.quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)),
               gmat)
    tmat = b.add_blinn(kd=(0.9, 0.85, 0.8), spec_amt=0.3, spec_exp=20.0)
    b.add_mesh(_teapot_sphere(), tmat)
    b.set_dome_light(sky, gain=1.0, num_samples=dome_samples)
    b.set_env_map(sky, 1.0)
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 2.5, 5), look_at=(0, 0.8, 0), fov=45.0)
    settings = _settings(
        device, width=size, height=size, path_trace=False,
        max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


# the final forest's tree prototypes: (trunk height, trunk radius) of the
# JAX registry's _procedural_trunk calls, scaled by TRUNK_SCALE so that the
# trunk reaches the stand-in canopy; leaf cards per canopy
TREES = ((1.2, 0.05), (1.5, 0.06))
TRUNK_SCALE = 5.0
LEAF_CARDS = assets.LEAF_CARDS


@register('final_forest_standin')
def final_forest_standin(width=1920, height=1080, n_trees=200, n_flowers=100,
                         grass_grid=40, max_bounces=5, dome_samples=2,
                         builder=None, bvh=False, device=CUDA, **kw):
    """The JAX registry's flagship `final_forest` (makeFinalScene) without
    asset files, at its defaults: the same rng seed (3163513), tree, flower
    and grass placement loops, materials, env exposure 1.5, dome gain 0.15,
    dome samples, thin-lens camera (aperture 0.0018, focus plane 2.0,
    shutter 0.1) and settings (Whitted, 5 bounces, 7 wavefront steps).
    Every mesh and image is generated (scenes/assets.py):

    * groundPlane.obj: a 2 km square of 20 x 20 quads, the texture tiled 20
      times on each; ground-dirt-texture.tga: brown grain;
    * explosion01/02.obj: a shattered 0.12 m glass sphere near the focus
      point, shards pushed 0.05-0.15 m outward at t = 1 (motion blur);
    * cannonBallT1/T2.obj: a 0.05 m sphere moving 0.25 m along x;
      bw2.tga: black and white checks;
    * the trees: the JAX registry's procedural trunks, 5 times larger, under
      a canopy of 1,500 alpha-cut leaf cards (an ellipsoid of radii 0.45,
      0.3, 0.45 times the trunk height); AL04/AL17 bark and autumn leaves:
      grain and RGBA leaf images (`assets.leaf_texture`);
    * the two flowers: a stem, bulbs, a ring of petal cards and leaf cards
      (alpha-cut on flower01), each at most 16 clusters; their nine images:
      coloured grain, and a bump map for the bulb;
    * testGrass.obj: a clump of 12 four-triangle blades; grassblade2.tga:
      green grain;
    * sky.hdr and the nyany env map: two procedural HDR skies.

    n_trees=0 leaves out all trees, the four hand-placed ones too, so that
    the scene's prototypes are all shallow and take the segment tracer.
    """
    rng = np.random.default_rng(3163513)
    b = SceneBuilder() if builder is None else builder

    # env + dome (src/main.cpp:149-165)
    env = b.add_texture(assets.sky_hdr(128, 256, sun_u=0.7, sun_el=20.0,
                                       sun_power=60.0,
                                       zenith=(0.3, 0.35, 0.6)))
    sky = b.add_texture(assets.sky_hdr(DOME_ROWS, 256))
    b.set_env_map(env, 1.5)
    b.set_dome_light(sky, gain=0.15, num_samples=dome_samples)
    b.set_bg_color((0, 0, 0))

    # ground plane with dirt texture (src/main.cpp:185-227)
    dirt = b.add_texture(assets.solid_texture((0.35, 0.25, 0.15), 128,
                                              grain=0.5, seed=21))
    dirt_mat = b.add_blinn(kd=(0.1, 0.1, 0.1), spec_exp=30.0, ior=1.8,
                           tex_color=dirt)
    b.add_mesh(assets.ground_grid(1000.0, 20, 20.0), dirt_mat)

    # motion-blurred dispersive glass explosion (src/main.cpp:167-203)
    glass = b.add_blinn(kd=(0.9, 0.9, 0.9), spec_exp=30.0, spec_amt=0.0,
                        ior=1.56, reflect_amt=1.0, refract_amt=1.0,
                        disperse=True)
    shards, shards_t1 = assets.shattered_sphere((0.35, 0.45, 0.4), 0.12, 8,
                                                12, 0.1, 22)
    b.add_mesh(shards, glass, shards_t1)

    # motion-blurred cannonball (src/main.cpp:205-223)
    bullet = b.add_texture(assets.checker_texture())
    cball = b.add_blinn(kd=(0.01, 0.01, 0.01), spec_exp=15.0, spec_amt=0.5,
                        ior=1.8, spec_gloss=0.9, tex_color=bullet)
    ball = shapes.uv_sphere((0.05, 0.4, 0.7), 0.05, 10, 16)
    b.add_mesh(ball, cball, assets.translated(ball, (0.25, 0.0, 0.0)))

    # ---- tree prototypes (src/main.cpp:230-395): trunk + alpha-cut leaves
    bark2 = b.add_texture(assets.solid_texture((0.3, 0.22, 0.15), 64,
                                               seed=31))
    leaves2 = b.add_texture(assets.leaf_texture(128, (0.6, 0.3, 0.08),
                                                seed=32))
    bark3 = b.add_texture(assets.solid_texture((0.25, 0.2, 0.16), 64,
                                               seed=33))
    leaves3 = b.add_texture(assets.leaf_texture(128, (0.55, 0.45, 0.1),
                                                seed=34))
    t2_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark2)
    t2_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves2,
                            tex_alpha=leaves2)
    t3_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark3)
    t3_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves3,
                            tex_alpha=leaves3)
    protos = []
    for k, ((th, tr), body, leaf) in enumerate(zip(
            TREES, (t2_body_m, t3_body_m), (t2_leaf_m, t3_leaf_m))):
        h = th * TRUNK_SCALE
        b.begin_prototype()
        b.add_mesh(procedural_trunk(h, tr * TRUNK_SCALE), body)
        b.add_mesh(assets.random_cards(LEAF_CARDS, (0.0, 0.85 * h, 0.0),
                                       (0.45 * h, 0.3 * h, 0.45 * h),
                                       0.08 * h, seed=40 + k, droop=0.5),
                   leaf)
        protos.append(b.end_prototype())
    tree2, tree3 = protos

    # makeTrees placement (src/main.cpp:54-76): ring outside |x|,|z| < 100
    placed = 0
    while placed < n_trees:
        x, z = rng.random(), rng.random()
        if x * x + z * z > 1.0:
            continue
        tx, tz = x * 800.0, -z * 800.0
        if tx < 100.0 and tz > -100.0:
            continue
        m = tf.translate(tx, rng.random() * 0.5 - 0.5, tz) \
            @ tf.scale(rng.random() * 0.3 + 0.85, rng.random() * 0.3 + 0.85,
                       rng.random() * 0.3 + 0.85) \
            @ tf.rotate_y(rng.random() * 360.0)
        b.add_instance(tree2 if placed % 2 == 0 else tree3, m)
        placed += 1
    if n_trees > 0:
        # the four hand-placed near trees (src/main.cpp:231-238, 283-306)
        b.add_instance(tree2, tf.translate(62.872, 0, -27.025)
                       @ tf.scale(0.64))
        b.add_instance(tree3, tf.translate(0, 0, -21.013))
        b.add_instance(tree3, tf.translate(43.078, 0, -9.234)
                       @ tf.rotate_y(-105.05))
        b.add_instance(tree2, tf.translate(10.92, 0, -53.16)
                       @ tf.scale(0.71) @ tf.rotate_y(100.0))

    # ---- flower prototypes (src/main.cpp:397-655)
    fl_bulb = b.add_texture(assets.solid_texture((0.9, 0.8, 0.2), seed=51))
    fl_bulb_n = b.add_texture(assets.normal_map(seed=52))
    fl_body_t = b.add_texture(assets.solid_texture((0.2, 0.5, 0.15),
                                                   seed=53))
    fl_leaf_t = b.add_texture(assets.solid_texture((0.25, 0.55, 0.2),
                                                   seed=54))
    fl_petal = b.add_texture(assets.solid_texture((0.95, 0.5, 0.6),
                                                  seed=55))
    fl01_lef1 = b.add_texture(assets.leaf_texture(64, (0.2, 0.5, 0.15),
                                                  seed=56))
    fl01_stm1 = b.add_texture(assets.solid_texture((0.3, 0.5, 0.2),
                                                   seed=57))
    fl01_flo1 = b.add_texture(assets.solid_texture((0.8, 0.3, 0.5),
                                                   seed=58))
    fl01_pet1 = b.add_texture(assets.solid_texture((0.9, 0.6, 0.8),
                                                   seed=59))
    fl01_stm2 = b.add_texture(assets.solid_texture((0.9, 0.85, 0.4),
                                                   seed=60))
    fl01_lef2 = b.add_texture(assets.leaf_texture(64, (0.25, 0.55, 0.2),
                                                  seed=61))

    def flower_mat(tex, transl=0.0, alpha=-1, normal=-1):
        return b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                           translucency=transl, tex_color=tex,
                           tex_alpha=alpha, tex_normal=normal)

    b.begin_prototype()
    b.add_mesh(shapes.cylinder((0, 0, 0), 0.008, 0.35, n_seg=6),
               flower_mat(fl_body_t))
    b.add_mesh(shapes.uv_sphere((0, 0.37, 0), 0.025, 6, 10),
               flower_mat(fl_bulb, normal=fl_bulb_n))
    b.add_mesh(assets.random_cards(6, (0, 0.12, 0), (0.06, 0.08, 0.06), 0.08,
                                   seed=62), flower_mat(fl_leaf_t, transl=0.5))
    b.add_mesh(assets.petal_ring(0.37, 0.05, 8, 0.06),
               flower_mat(fl_petal, transl=0.6))
    flower02 = b.end_prototype()

    b.begin_prototype()
    b.add_mesh(assets.random_cards(8, (0, 0.08, 0), (0.1, 0.06, 0.1), 0.12,
                                   seed=64, droop=1.0),
               flower_mat(fl01_lef1, transl=0.6, alpha=fl01_lef1))
    b.add_mesh(shapes.cylinder((0, 0, 0), 0.006, 0.3, n_seg=6),
               flower_mat(fl01_stm1))
    for k, (x, y, z) in enumerate(((0.0, 0.31, 0.0), (0.03, 0.27, 0.01),
                                   (-0.02, 0.25, -0.02))):
        b.add_mesh(shapes.uv_sphere((x, y, z), 0.015, 5, 8),
                   flower_mat(fl01_flo1))
    b.add_mesh(assets.petal_ring(0.31, 0.04, 10, 0.05),
               flower_mat(fl01_pet1, transl=0.6))
    b.add_mesh(shapes.cylinder((0, 0.3, 0), 0.002, 0.03, n_seg=4),
               flower_mat(fl01_stm2))
    b.add_mesh(assets.random_cards(10, (0, 0.18, 0), (0.05, 0.05, 0.05),
                                   0.05, seed=66),
               flower_mat(fl01_lef2, transl=0.6, alpha=fl01_lef2))
    flower01 = b.end_prototype()

    cam_eye = np.asarray((-1.277, 0.158, 2.139), np.float32)
    # makeFlowers placement (src/main.cpp:78-97): disc around the camera,
    # the JAX registry's draw order and composition
    for i in range(n_flowers):
        while True:
            x, z = rng.random(), rng.random()
            if x * x + z * z <= 1.0:
                break
        trans = tf.translate(cam_eye[0] + x * 10.0,
                             rng.random() * 0.05 - 0.025,
                             cam_eye[2] - z * 10.0)
        sc = tf.scale(rng.random() * 0.2 + 0.9, rng.random() * 0.2 + 0.95,
                      rng.random() * 0.2 + 0.9)
        tilt = tf.rotate_x(rng.random() * 20.0 + 10.0)
        yaw = tf.rotate_y(rng.random() * 360.0)
        b.add_instance(flower02 if i % 2 else flower01, trans @ sc @ yaw @ tilt)

    # ---- grass proxy grid (makeProxyGrid, src/main.cpp:38-52)
    grass_tex = b.add_texture(assets.solid_texture((0.3, 0.6, 0.15), 16,
                                                   grain=0.3, seed=71))
    grass_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                          tex_color=grass_tex)
    b.begin_prototype()
    b.add_mesh(assets.grass_clump(12, seed=72), grass_m)
    grass = b.end_prototype()
    for i in range(grass_grid):
        for j in range(grass_grid):
            m = tf.translate(-2 + i * (rng.random() * 0.2 + 0.2), 0,
                             3 - j * (rng.random() * 0.2 + 0.2)) \
                @ tf.scale(rng.random() * 0.3 + 0.85,
                           rng.random() * 0.3 + 0.7,
                           rng.random() * 0.3 + 0.85) \
                @ tf.rotate_y(rng.random() * 360.0)
            b.add_instance(grass, m)

    scene = _build(b, bvh, device)
    cam = Camera.make(eye=cam_eye, look_at=(0.294, 0.511, 0.503),
                      fov=39.0, aperture=0.0018, focus_plane=2.0,
                      shutter=0.1)
    settings = _settings(
        device, width=width, height=height, path_trace=False,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings


# ------------------------------------------------------------ asset scenes
# The JAX registry's scenes that read the reference checkout's files, line
# for line: the same parameters, seeds, draw order, cameras and settings.

MODELS, TEXTURES, IMAGES = 'Models', 'Textures', 'Images'


def asset_root() -> str:
    """The asset tree: RT_ASSETS, read when a scene is built, or the
    reference checkout at ~/reference."""
    return os.environ.get('RT_ASSETS',
                          os.path.join(os.path.expanduser('~'), 'reference'))


def asset_path(*parts: str) -> str:
    """A file of the asset tree; FileNotFoundError if it is not there (a
    builder never puts a stand-in in its place)."""
    path = os.path.join(asset_root(), *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f'{path}: no such asset file; RT_ASSETS names the asset tree '
            f'(a reference checkout, or scenes/assets.write_tree)')
    return path


def _cornell_box(b, emitter_power=0.0):
    """Shared Cornell geometry (makePathTracingScene,
    src/assignment2.h:379-438)."""
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=emitter_power, le=(1, 1, 1))
    b.add_mesh(load_obj(asset_path(MODELS, 'cornell_box-light.obj')), lmat)
    wmat = b.add_blinn(kd=(1, 1, 1))
    b.add_mesh(load_obj(asset_path(MODELS, 'cornell_box-white.obj')), wmat)
    rmat = b.add_blinn(kd=(0.80, 0.20, 0.20))
    b.add_mesh(load_obj(asset_path(MODELS, 'cornell_box-red.obj')), rmat)
    gmat = b.add_blinn(kd=(0.20, 0.80, 0.20))
    b.add_mesh(load_obj(asset_path(MODELS, 'cornell_box-green.obj')), gmat)


@register('cornell_pt')
def cornell_pt(size=512, num_rect_samples=4, bvh=True, max_bounces=5,
               builder=None, device=CUDA, **kw):
    """Cornell box, path traced, area RectangleLight (BASELINE config #2;
    makePathTracingScene, src/assignment2.h:379-438)."""
    b = SceneBuilder() if builder is None else builder
    _cornell_box(b, emitter_power=50.0)
    b.add_rect_light((3.0, 5.5, -2.5), (3.0, 5.5, -3.0), (2.5, 5.5, -2.5),
                     power=10.0, num_samples=num_rect_samples)
    b.set_bg_color((0, 0, 0))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(2.25, 2.25, 5.5), look_at=(2.5, 2.25, 0), fov=55.0)
    settings = _settings(
        device, width=size, height=size, path_trace=True,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings


@register('cornell_spheres')
def cornell_spheres(size=512, bvh=True, builder=None, device=CUDA, **kw):
    """Cornell box with a glass and a glossy metal sphere, adaptive 1..4
    subdivs (makePathTracingScene3, src/assignment2.h:440-524); every IOR
    channel 2.2, as in the JAX registry."""
    b = SceneBuilder() if builder is None else builder
    cb = 'CornellBox'
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=0.0, le=(1, 1, 1))
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Box_light.obj')), lmat)
    wmat = b.add_blinn(kd=(1, 1, 1))
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Box_white.obj')), wmat)
    rmat = b.add_blinn(kd=(0.80, 0.20, 0.20))
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Box_red.obj')), rmat)
    gmat = b.add_blinn(kd=(0.20, 0.80, 0.20))
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Box_green.obj')), gmat)
    glass = b.add_blinn(kd=(0.7, 0.1, 0.05), spec_exp=30.0, ior=2.2,
                        reflect_amt=1.0, refract_amt=1.0)
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Sphere_Glass.obj')), glass)
    metal = b.add_blinn(kd=(0.09, 0.094, 0.1), spec_exp=30.0, spec_amt=0.0,
                        ior=6.0, reflect_amt=0.90, refract_amt=0.0,
                        spec_gloss=0.98)
    b.add_mesh(load_obj(asset_path(MODELS, cb, 'Sphere_Metal.obj')), metal)
    b.add_rect_light((3.0, 5.5, -2.5), (3.0, 5.5, -3.0), (2.5, 5.5, -2.5),
                     power=15.0, num_samples=1)
    b.set_bg_color((0, 0, 0))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(2.75, 2.75, 5.0), look_at=(2.75, 2.75, 0),
                      fov=55.0, focus_plane=8.6, aperture=0.0)
    settings = _settings(
        device, width=size, height=size, path_trace=True, max_bounces=5,
        min_subdivs=1, max_subdivs=4, noise_threshold=0.01,
        max_wavefront_steps=8, **kw)
    return scene, _on(cam, device), settings


@register('teapot_blinn')
def teapot_blinn(size=512, bvh=True, spec=True, builder=None, device=CUDA,
                 **kw):
    """Teapot and floor, Blinn, point light (BASELINE config #3 stand-in,
    makeTeapotScene2, src/assignment2.h:34-80)."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(1, 1, 1),
                      spec_amt=0.5 if spec else 0.0, spec_exp=30.0)
    b.add_mesh(load_obj(asset_path(MODELS, 'teapot.obj')), mat)
    b.add_mesh(make_single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10),
                                    n=(0, 1, 0)), mat)
    b.add_point_light((10, 10, 10), 700.0)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('dome_teapot')
def dome_teapot(size=512, hdr='sky.hdr', dome_samples=4, bvh=True,
                ground='grass', builder=None, device=CUDA, **kw):
    """Textured ground and teapot under an importance-sampled HDR
    DomeLight (BASELINE config #4 stand-in; makeFinalScene's sky.hdr dome,
    src/main.cpp:150-165). ground='stone' bakes the procedural stone
    texture (shading/procedural.py) onto the ground plane, on `device`."""
    b = SceneBuilder() if builder is None else builder
    sky = b.add_texture_file(asset_path(TEXTURES, hdr))
    if ground == 'stone':
        from ..shading.procedural import bake_stone_texture
        grass = b.add_texture(
            bake_stone_texture(size=256, device=device).cpu().numpy())
    else:
        grass = b.add_texture_file(asset_path(TEXTURES,
                                              'grass-color-01.tga'))
    gmat = b.add_blinn(kd=(1, 1, 1), tex_color=grass)
    b.add_mesh(shapes.quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)),
               gmat)
    tmat = b.add_blinn(kd=(0.9, 0.85, 0.8), spec_amt=0.3, spec_exp=20.0)
    b.add_mesh(load_obj(asset_path(MODELS, 'teapot.obj')), tmat)
    b.set_dome_light(sky, gain=1.0, num_samples=dome_samples)
    b.set_env_map(sky, 1.0)
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 2.5, 5), look_at=(0, 0.8, 0), fov=45.0)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('mb_bullet')
def mb_bullet(size=256, bvh=True, shutter=1.0, builder=None, device=CUDA,
              **kw):
    """Motion blur: the shattered-bullet two-pose mesh pair
    (bulletMB_01/02.obj; MBObject, makeFinalScene src/main.cpp:167-200)."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.8, 0.7, 0.2), spec_amt=0.4, spec_exp=15.0)
    m0 = load_obj(asset_path(MODELS, 'bulletMB_01.obj'))
    m1 = load_obj(asset_path(MODELS, 'bulletMB_02.obj'))
    b.add_mesh(m0, mat, mesh_t1=m1)
    floor = b.add_lambert(kd=(0.7, 0.7, 0.7))
    b.add_mesh(make_single_triangle((-20, -2, -20), (0, -2, 20), (20, -2, -20),
                                    n=(0, 1, 0)), floor)
    b.add_point_light((5, 10, 5), 500.0)
    b.set_bg_color((0.1, 0.1, 0.15))
    scene = _build(b, bvh, device)
    lo = m0.vertices.min(0)
    hi = m0.vertices.max(0)
    c = 0.5 * (lo + hi)
    cam = Camera.make(eye=c + np.asarray([0, 0.5, 3.5]) * (hi - lo).max(),
                      look_at=c, fov=45.0, shutter=shutter)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('instanced_teapots')
def instanced_teapots(size=256, grid=4, bvh=True, builder=None, device=CUDA,
                      **kw):
    """Two-level instancing: grid x grid teapots (ProxyObject grids,
    makeBunny20Scene2 src/assignment2.h:137+, makeProxyGrid
    src/main.cpp:37). Built with its BVH whatever `bvh` says, as in the
    JAX registry."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.8, 0.5, 0.3), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(load_obj(asset_path(MODELS, 'teapot.obj')), mat)
    proto = b.end_prototype()
    # the reference's MT seed (src/Scene.cpp:28)
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
    scene = _build(b, True, device)
    cam = Camera.make(eye=(0, 8, grid * 2.5 + 6), look_at=(0, 0.5, 0),
                      fov=45.0)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('instanced_grid')
def instanced_grid(size=256, n=100_000, spacing=2.0, builder=None,
                   device=CUDA, **kw):
    """n teapots on a jittered grid, one shared prototype (the reference's
    1M instanced bunnies, src/ProxyObject.cpp:149-167,
    src/BVH.cpp:1305-1338). Built with its BVH, as in the JAX registry."""
    b = SceneBuilder() if builder is None else builder
    mat = b.add_blinn(kd=(0.75, 0.55, 0.35), spec_amt=0.3, spec_exp=20.0)
    b.begin_prototype()
    b.add_mesh(load_obj(asset_path(MODELS, 'teapot.obj')), mat)
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
    scene = _build(b, True, device)
    cam = Camera.make(eye=(0, g * spacing * 0.12, g * spacing * 0.55),
                      look_at=(0, 0.0, 0), fov=50.0)
    settings = _settings(device, width=size, height=size, path_trace=False,
                         max_wavefront_steps=2, **kw)
    return scene, _on(cam, device), settings


@register('sponza_proxy')
def sponza_proxy(width=1920, height=1080, bvh=True, path_trace=True,
                 max_bounces=10, rect_samples=1, hd=False, builder=None,
                 device=CUDA, **kw):
    """The atrium around the original sponza light quad
    (Models/sponza-light.obj) and rect light (makeSponzaScenePathTrace,
    src/assignment2.h:663-710): floor, walls, colonnade, teapot clutter
    (n_teapots=, default 100, or 300 with hd). hd=True, bench.py's
    configuration, adds the second-story gallery slabs, the upper
    colonnade and the balustrade blocks."""
    b = SceneBuilder() if builder is None else builder
    white = b.add_blinn(kd=(1, 1, 1))
    lmat = b.add_blinn(kd=(1, 1, 1), emitted_power=1.5, le=(1, 1, 1))
    b.add_mesh(load_obj(asset_path(MODELS, 'sponza-light.obj')), lmat)
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
    if hd:
        # second-story gallery: side slabs around the central opening,
        # upper colonnade and balustrade blocks between the upper columns
        for z0, z1 in ((-5.0, -2.5), (2.5, 5.0)):
            b.add_mesh(shapes.box((-10, 4.8, z0), (10, 5.0, z1)), white)
        for x0, x1 in ((-10.0, -8.5), (8.5, 10.0)):
            b.add_mesh(shapes.box((x0, 4.8, -2.5), (x1, 5.0, 2.5)), white)
        for i in range(12):
            x = -9 + i * 1.64
            for z in (-3.0, 3.0):
                b.add_mesh(shapes.cylinder((x, 5.0, z), 0.25, 3.0,
                                           n_seg=16), white)
                b.add_mesh(shapes.box((x - 0.7, 5.0, z - 0.08),
                                      (x + 0.7, 5.6, z + 0.08)), white)
    # clutter to sponza-scale triangle counts
    teapot = load_obj(asset_path(MODELS, 'teapot.obj'))
    compute_tangents(teapot)
    rng = np.random.default_rng(3163513)
    n_teapots = kw.pop('n_teapots', 300 if hd else 100)
    for k in range(n_teapots):
        t = teapot.vertices * rng.uniform(0.2, 0.5)
        # hd: a third of the clutter lives on the upper gallery
        if hd and k % 3 == 0:
            t = t + np.asarray([rng.uniform(-9, 9), 5.0,
                                rng.uniform(-4.6, -2.8)], np.float32)
        else:
            t = t + np.asarray([rng.uniform(-9, 9), 0.0,
                                rng.uniform(-4, 4)], np.float32)
        m = MeshData(vertices=t.astype(np.float32), normals=teapot.normals,
                     texcoords=teapot.texcoords, face_v=teapot.face_v,
                     face_n=teapot.face_n, face_t=teapot.face_t,
                     tangents=teapot.tangents, bitangents=teapot.bitangents)
        b.add_mesh(m, white)
    b.add_rect_light((8.0, 10, 2), (8.0, 10, -2.0), (-8, 10, 2), power=1.5,
                     num_samples=rect_samples)
    b.set_bg_color((0.0, 0.0, 0.2))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55.0)
    settings = _settings(
        device, width=width, height=height, path_trace=path_trace,
        max_bounces=max_bounces,
        max_wavefront_steps=max_bounces + 2 if path_trace else 2, **kw)
    return scene, _on(cam, device), settings


@register('alpha_leaf')
def alpha_leaf(size=256, bvh=True, max_bounces=5, builder=None, device=CUDA,
               **kw):
    """makeAlphaTest (src/Assignment3.h:19-95): two leaf_test.obj quads with
    Tree_03_Leaves.tga as both colour and alpha map (cutout), translucency
    0.9, a point light from below and behind, the
    Topanga_Forest_B_light.hdr env map, path traced."""
    b = SceneBuilder() if builder is None else builder
    leaf_tex = b.add_texture_file(asset_path(TEXTURES, 'Tree_03_Leaves.tga'))
    env = b.add_texture_file(asset_path(IMAGES,
                                        'Topanga_Forest_B_light.hdr'))
    leaf2 = b.add_blinn(kd=(1, 1, 1), translucency=0.9,
                        tex_color=leaf_tex, tex_alpha=leaf_tex)
    b.add_mesh(load_obj(asset_path(MODELS, 'leaf_test.obj'),
                        tf.translate(-2, 0, 0)), leaf2)
    b.add_mesh(load_obj(asset_path(MODELS, 'leaf_test.obj'),
                        tf.translate(-1, 0.5, 0)), leaf2)
    b.add_point_light((-10, -10, -10), 4000.0)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45.0,
                      aperture=0.001, focus_plane=4.0)
    settings = _settings(
        device, width=size, height=size, path_trace=True,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings


@register('dispersion')
def dispersion(size=256, bvh=True, max_bounces=6, dome_samples=6,
               builder=None, device=CUDA, **kw):
    """testDispersion (src/Assignment3.h:97-193): a glass sphere with
    per-channel IOR (1.57, 1.60, 1.62), disperse=True, a sky.hdr dome light
    (gain 0.15, 6 samples), the Topanga env map, path traced."""
    b = SceneBuilder() if builder is None else builder
    sky = b.add_texture_file(asset_path(IMAGES, 'sky.hdr'))
    env = b.add_texture_file(asset_path(IMAGES,
                                        'Topanga_Forest_B_light.hdr'))
    glass = b.add_blinn(kd=(0.0, 0.5, 0.5), spec_exp=30.0,
                        ior=(1.57, 1.60, 1.62), reflect_amt=1.0,
                        refract_amt=1.0, disperse=True)
    b.add_mesh(load_obj(asset_path(MODELS, 'sphere2.obj')), glass)
    b.set_dome_light(sky, gain=0.15, num_samples=dome_samples)
    b.set_env_map(env, 1.0)
    b.set_bg_color((0, 0, 0))
    scene = _build(b, bvh, device)
    cam = Camera.make(eye=(0, 3, 6), look_at=(0, 2, 0), fov=45.0,
                      aperture=0.001, focus_plane=4.0)
    settings = _settings(
        device, width=size, height=size, path_trace=True,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings


@register('final_forest')
def final_forest(width=1920, height=1080, bvh=True, n_trees=200,
                 n_flowers=100, grass_grid=40, max_bounces=5,
                 flatten=False, builder=None, device=CUDA, **kw):
    """The flagship scene: makeFinalScene (src/main.cpp:132-671).

    An instanced forest (tree prototypes with alpha-cut leaf textures and
    translucency), flower prototypes, a grass proxy grid, a motion-blurred
    dispersive glass explosion and textured cannonball, a dirt ground
    plane, the sky.hdr dome light, an HDR env background and the thin-lens
    camera with a 0.1 shutter (camera01Settings, src/main.cpp:107-118).
    The trunks are procedural (`procedural_trunk`, the JAX registry's
    stand-in for the unshipped Tree0*Body.obj).

    flatten=True bakes every placement into world-space triangles
    (single-level: the cluster tracer), at the cost of memory in
    proportion to the flattened triangle count; flatten=False keeps true
    two-level instancing.
    """
    rng = np.random.default_rng(3163513)
    b = SceneBuilder() if builder is None else builder

    class _Inst:
        """Prototype/instance shim: flatten=True bakes each placement as
        world-space geometry, flatten=False adds a prototype instance."""
        def __init__(self):
            self.protos = []
            self.cur = None

        def begin(self):
            if flatten:
                self.cur = []
            else:
                b.begin_prototype()

        def mesh(self, mesh, mat):
            if flatten:
                self.cur.append((mesh, mat))
            else:
                b.add_mesh(mesh, mat)

        def end(self):
            if flatten:
                self.protos.append(self.cur)
                self.cur = None
                return len(self.protos) - 1
            return b.end_prototype()

        def inst(self, proto, m):
            if flatten:
                for mesh, mat in self.protos[proto]:
                    b.add_mesh(transform_mesh(mesh, m), mat)
            else:
                b.add_instance(proto, m)

    I = _Inst()

    # env + dome (src/main.cpp:149-165)
    env = b.add_texture_file(asset_path(TEXTURES,
                                        'hdrvfx_nyany_1_n2_v101_Ref.hdr'))
    sky = b.add_texture_file(asset_path(IMAGES, 'sky.hdr'))
    b.set_env_map(env, 1.5)
    b.set_dome_light(sky, gain=0.15, num_samples=kw.pop('dome_samples', 2))
    b.set_bg_color((0, 0, 0))

    # ground plane with dirt texture (src/main.cpp:185-227)
    dirt = b.add_texture_file(asset_path(TEXTURES, 'ground-dirt-texture.tga'))
    dirt_mat = b.add_blinn(kd=(0.1, 0.1, 0.1), spec_exp=30.0, ior=1.8,
                           tex_color=dirt)
    b.add_mesh(load_obj(asset_path(MODELS, 'Final', 'groundPlane.obj')),
               dirt_mat)

    # motion-blurred dispersive glass explosion (src/main.cpp:167-203)
    glass = b.add_blinn(kd=(0.9, 0.9, 0.9), spec_exp=30.0, spec_amt=0.0,
                        ior=1.56, reflect_amt=1.0, refract_amt=1.0,
                        disperse=True)
    b.add_mesh(load_obj(asset_path(MODELS, 'Final', 'explosion01.obj')),
               glass,
               load_obj(asset_path(MODELS, 'Final', 'explosion02.obj')))

    # motion-blurred cannonball (src/main.cpp:205-223)
    bullet = b.add_texture_file(asset_path(TEXTURES, 'bw2.tga'))
    cball = b.add_blinn(kd=(0.01, 0.01, 0.01), spec_exp=15.0, spec_amt=0.5,
                        ior=1.8, spec_gloss=0.9, tex_color=bullet)
    b.add_mesh(load_obj(asset_path(MODELS, 'Final', 'cannonBallT1.obj')),
               cball,
               load_obj(asset_path(MODELS, 'Final', 'cannonBallT2.obj')))

    # ---- tree prototypes (src/main.cpp:230-395): procedural trunk + the
    # alpha-cut leaves
    bark2 = b.add_texture_file(asset_path(TEXTURES, 'AL04brk.tga'))
    leaves2 = b.add_texture_file(asset_path(TEXTURES, 'AL04aut.tga'))
    bark3 = b.add_texture_file(asset_path(TEXTURES, 'AL17brk.tga'))
    leaves3 = b.add_texture_file(asset_path(TEXTURES, 'AL17aut.tga'))
    t2_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark2)
    t2_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves2,
                            tex_alpha=leaves2)
    t3_body_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            tex_color=bark3)
    t3_leaf_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                            translucency=0.6, tex_color=leaves3,
                            tex_alpha=leaves3)

    I.begin()
    I.mesh(procedural_trunk(), t2_body_m)
    I.mesh(load_obj(asset_path(MODELS, 'Final', 'tree02Leaves.obj')),
           t2_leaf_m)
    tree2 = I.end()
    I.begin()
    I.mesh(procedural_trunk(1.5, 0.06), t3_body_m)
    I.mesh(load_obj(asset_path(MODELS, 'Final', 'tree03Leaves.obj')),
           t3_leaf_m)
    tree3 = I.end()

    # makeTrees placement (src/main.cpp:54-76): ring outside |x|,|z| < 100
    placed = 0
    while placed < n_trees:
        x, z = rng.random(), rng.random()
        if x * x + z * z > 1.0:
            continue
        tx, tz = x * 800.0, -z * 800.0
        if tx < 100.0 and tz > -100.0:
            continue
        m = tf.translate(tx, rng.random() * 0.5 - 0.5, tz) \
            @ tf.scale(rng.random() * 0.3 + 0.85, rng.random() * 0.3 + 0.85,
                       rng.random() * 0.3 + 0.85) \
            @ tf.rotate_y(rng.random() * 360.0)
        I.inst(tree2 if placed % 2 == 0 else tree3, m)
        placed += 1
    # the four hand-placed near trees (src/main.cpp:231-238, 283-306)
    I.inst(tree2, tf.translate(62.872, 0, -27.025) @ tf.scale(0.64))
    I.inst(tree3, tf.translate(0, 0, -21.013))
    I.inst(tree3, tf.translate(43.078, 0, -9.234) @ tf.rotate_y(-105.05))
    I.inst(tree2, tf.translate(10.92, 0, -53.16) @ tf.scale(0.71)
           @ tf.rotate_y(100.0))

    # ---- flower prototypes (src/main.cpp:397-655)
    fl_bulb = b.add_texture_file(asset_path(TEXTURES, 'bud-yellow-1.tga'))
    fl_bulb_n = b.add_texture_file(asset_path(TEXTURES,
                                              'bud-yellow-1-bump_NRM.tga'))
    fl_body_t = b.add_texture_file(asset_path(TEXTURES, 'grass-color-23.tga'))
    fl_leaf_t = b.add_texture_file(asset_path(TEXTURES, 'grass-color-18.tga'))
    fl_petal = b.add_texture_file(asset_path(TEXTURES, 'petal-pink-02.tga'))
    fl01_lef1 = b.add_texture_file(asset_path(TEXTURES, 'FL30lef1.tga'))
    fl01_stm1 = b.add_texture_file(asset_path(TEXTURES, 'FL30stm1.tga'))
    fl01_flo1 = b.add_texture_file(asset_path(TEXTURES, 'FL30flo1.tga'))
    fl01_pet1 = b.add_texture_file(asset_path(TEXTURES, 'FL30pet1.tga'))
    fl01_stm2 = b.add_texture_file(asset_path(TEXTURES, 'FL30stm2.tga'))
    fl01_lef2 = b.add_texture_file(asset_path(TEXTURES, 'FL30lef2.tga'))

    def flower_mat(tex, transl=0.0, alpha=-1, normal=-1):
        return b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                           translucency=transl, tex_color=tex,
                           tex_alpha=alpha, tex_normal=normal)

    def F(name):
        return load_obj(asset_path(MODELS, 'Final', name))

    I.begin()
    I.mesh(F('flower02Body.obj'), flower_mat(fl_body_t))
    I.mesh(F('flower02Bulb.obj'), flower_mat(fl_bulb, normal=fl_bulb_n))
    I.mesh(F('flower02Leaves.obj'), flower_mat(fl_leaf_t, transl=0.5))
    I.mesh(F('flower02Petals.obj'), flower_mat(fl_petal, transl=0.6))
    flower02 = I.end()

    I.begin()
    I.mesh(F('flower01BigLeaves.obj'),
           flower_mat(fl01_lef1, transl=0.6, alpha=fl01_lef1))
    I.mesh(F('flower01Body.obj'), flower_mat(fl01_stm1))
    I.mesh(F('flower01Bulbs01.obj'), flower_mat(fl01_flo1))
    I.mesh(F('flower01Bulbs02.obj'), flower_mat(fl01_flo1))
    I.mesh(F('flower01Bulbs03.obj'), flower_mat(fl01_flo1))
    I.mesh(F('flower01Petals.obj'), flower_mat(fl01_pet1, transl=0.6))
    I.mesh(F('flower01Pistils.obj'), flower_mat(fl01_stm2))
    I.mesh(F('flower01SmallLeaves.obj'),
           flower_mat(fl01_lef2, transl=0.6, alpha=fl01_lef2))
    flower01 = I.end()

    cam_eye = np.asarray((-1.277, 0.158, 2.139), np.float32)
    # makeFlowers placement (src/main.cpp:78-97): a disc around the camera,
    # the JAX registry's draw order and composition (its scale is a proper
    # S before the rotations, where the reference scales the diagonal of
    # the rotated matrix, src/Matrix4x4.h:757-762)
    for i in range(n_flowers):
        while True:
            x, z = rng.random(), rng.random()
            if x * x + z * z <= 1.0:
                break
        trans = tf.translate(cam_eye[0] + x * 10.0,
                             rng.random() * 0.05 - 0.025,
                             cam_eye[2] - z * 10.0)
        sc = tf.scale(rng.random() * 0.2 + 0.9, rng.random() * 0.2 + 0.95,
                      rng.random() * 0.2 + 0.9)
        tilt = tf.rotate_x(rng.random() * 20.0 + 10.0)
        yaw = tf.rotate_y(rng.random() * 360.0)
        m = trans @ sc @ yaw @ tilt
        I.inst(flower02 if i % 2 else flower01, m)

    # ---- grass proxy grid (makeProxyGrid, src/main.cpp:38-52)
    grass_tex = b.add_texture_file(asset_path(TEXTURES, 'grassblade2.tga'))
    grass_m = b.add_blinn(kd=(0.5, 0.5, 0.5), spec_exp=20.0, spec_amt=0.8,
                          tex_color=grass_tex)
    I.begin()
    I.mesh(load_obj(asset_path(MODELS, 'testGrass.obj')), grass_m)
    grass = I.end()
    for i in range(grass_grid):
        for j in range(grass_grid):
            m = tf.translate(-2 + i * (rng.random() * 0.2 + 0.2), 0,
                             3 - j * (rng.random() * 0.2 + 0.2)) \
                @ tf.scale(rng.random() * 0.3 + 0.85,
                           rng.random() * 0.3 + 0.7,
                           rng.random() * 0.3 + 0.85) \
                @ tf.rotate_y(rng.random() * 360.0)
            I.inst(grass, m)

    scene = _build(b, bvh, device)
    cam = Camera.make(eye=cam_eye, look_at=(0.294, 0.511, 0.503),
                      fov=39.0, aperture=0.0018, focus_plane=2.0,
                      shutter=0.1)
    settings = _settings(
        device, width=width, height=height, path_trace=False,
        max_bounces=max_bounces, max_wavefront_steps=max_bounces + 2, **kw)
    return scene, _on(cam, device), settings
