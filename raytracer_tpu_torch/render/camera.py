"""Primary rays: pinhole + thin-lens depth of field + shutter time.

Port of raytracer_tpu/render/camera.py (Camera::eyeRay, src/Camera.cpp:88-175).
rands[..., 0:2] jitter the sub-pixel position, rands[..., 2:4] sample the
aperture disc (polar warp), rands[..., 4] the shutter time.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import Camera
from ..core.vecmath import EPSILON, PI


def camera_basis(cam: Camera):
    """(uDir, vDir, wDir) with wDir = -viewDir (src/Camera.cpp:93-95)."""
    w = vm.normalize(-cam.view_dir)
    u = vm.normalize(vm.cross(cam.up, w))
    v = vm.cross(w, u)
    return u, v, w


def eye_rays(cam: Camera, width: int, height: int, px, py,
             off_min_x, off_max_x, off_min_y, off_max_y, rands):
    """Camera rays -> (origin (R, 3), dir (R, 3), time (R,)).

    px, py: pixel coordinates as floats (y = 0 is the bottom scanline);
    the offsets bound the jitter sub-quadrant (src/Camera.cpp:143-150)."""
    u_dir, v_dir, w_dir = camera_basis(cam)
    f32 = torch.float32
    aspect = torch.tensor(width, dtype=f32) / torch.tensor(height, dtype=f32)
    top = torch.tan(cam.fov * (PI / 360.0))
    right = aspect.to(top.device) * top

    x_off = (off_max_x - off_min_x) * rands[..., 0] + off_min_x
    y_off = (off_max_y - off_min_y) * rands[..., 1] + off_min_y
    im_u = -right + 2.0 * right * ((px + x_off) / width)
    im_v = -top + 2.0 * top * ((py + y_off) / height)
    d = vm.normalize(im_u[..., None] * u_dir + im_v[..., None] * v_dir - w_dir)

    r = rands[..., 4]
    time = 1.0 - r * r * r * cam.shutter

    radius = torch.sqrt(rands[..., 2])
    phi = 2.0 * PI * rands[..., 3]
    du = radius * torch.cos(phi)
    dv = radius * torch.sin(phi)
    focal = d * cam.focus_plane + cam.eye
    o_dof = cam.aperture * (du[..., None] * u_dir + dv[..., None] * v_dir) \
        + cam.eye
    d_dof = vm.normalize(focal - o_dof)

    if bool(cam.aperture >= EPSILON):
        return o_dof, d_dof, time
    return cam.eye.expand_as(d), d, time


def pixel_coords(width: int, height: int, device=None):
    """Flattened (px, py) float32 pixel coordinates, row 0 = bottom."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing='ij')
    return xs.reshape(-1), ys.reshape(-1)


def center_rays(cam: Camera, width: int, height: int):
    """Center-of-pixel rays for the whole image (src/Camera.cpp:88-114)
    -> (o, d, time) of shape (H*W, 3) / (H*W,), row 0 = bottom."""
    px, py = pixel_coords(width, height, cam.eye.device)
    rands = torch.zeros((px.shape[0], 5), dtype=torch.float32,
                        device=px.device)
    return eye_rays(cam, width, height, px, py, 0.5, 0.5, 0.5, 0.5, rands)
