"""Named scene fixtures that need no asset files.

Each builder returns (Scene, Camera, RenderSettings), as in
raytracer_tpu/scenes/registry.py. `builder=` takes any object with the
SceneBuilder interface, so a test can pass `raytracer_tpu.SceneBuilder()`
and have the JAX package build the very same scene.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Camera, RenderSettings
from ..geometry.build import SceneBuilder
from ..geometry import shapes
from ..io.objload import make_single_triangle

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
