"""Host-side affine transform builders (numpy 4x4, row-major).

Port of raytracer_tpu/core/transforms.py, unchanged: numpy only.

The reference's Matrix4x4 TRS builders (src/Matrix4x4.h:21-81:
rotate/rotateX/Y/Z/scale/translate, each composing onto the current matrix)
expressed as free functions returning 4x4 matrices composed with `@`.
The reference mutates in place with post-calls (m.rotate(); m.scale();
m.translate() builds translate @ scale @ rotate); `trs()` mirrors that
calling order.

Scene code passes the top 3x4 of the result to SceneBuilder.add_instance;
normals are fixed up by the inverse transpose at hit time
(src/Ray.cpp:27-31 semantics, render/integrator.hit_attributes).
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def scale(sx: float, sy: float | None = None, sz: float | None = None) -> np.ndarray:
    if sy is None:
        sy = sz = sx
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def rotate(deg: float, ax: float, ay: float, az: float) -> np.ndarray:
    """Rotation about an arbitrary axis (src/Matrix4x4.h rotate semantics)."""
    axis = np.asarray([ax, ay, az], np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return identity()
    x, y, z = axis / n
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    C = 1.0 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]], np.float32)
    return m


def rotate_x(deg: float) -> np.ndarray:
    return rotate(deg, 1.0, 0.0, 0.0)


def rotate_y(deg: float) -> np.ndarray:
    return rotate(deg, 0.0, 1.0, 0.0)


def rotate_z(deg: float) -> np.ndarray:
    return rotate(deg, 0.0, 0.0, 1.0)


def trs(translation=(0.0, 0.0, 0.0), rotation_y_deg: float = 0.0,
        scaling=(1.0, 1.0, 1.0)) -> np.ndarray:
    """translate @ scale @ rotateY — the reference's common
    m.rotate(a,0,1,0); m.scale(...); m.translate(...) idiom
    (e.g. makeTrees, src/main.cpp:64-67)."""
    s = scaling if np.ndim(scaling) else (scaling, scaling, scaling)
    return translate(*translation) @ scale(*s) @ rotate_y(rotation_y_deg)
