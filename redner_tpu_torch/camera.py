"""Perspective camera (port of the perspective path of redner_tpu/camera.py;
reference src/camera.h:122-197, src/camera.cpp:8-43).

Conventions (identical to the reference):
  * screen space is [0,1]^2 with x right, y down;
  * film plane mapping: [0,1]^2 -> [-1,1] x [1,-1]/aspect, aspect = W/H;
  * cam_to_world columns are (right, up, forward, position);
  * the local forward axis is +z.

The camera's leaves (position, look_at, up, fov) are tensors that may
require grad; cam_to_world and the intrinsic matrix are derived from them
on every call, so autograd reaches the leaves.  Orthographic, fisheye,
panorama and lens distortion are not ported yet and raise.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from redner_tpu_torch.core import transform as xf
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import Ray, RayDifferential
from redner_tpu_torch.device import resolve_device


class CameraType(enum.Enum):
    perspective = 0
    orthographic = 1
    fisheye = 2
    panorama = 3


@dataclass
class Camera:
    position: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov: torch.Tensor  # () degrees
    camera_type: CameraType = CameraType.perspective
    resolution: Tuple[int, int] = (256, 256)  # (height, width)
    viewport: Optional[Tuple[int, int, int, int]] = None  # (top, left, bottom, right)
    clip_near: float = 1e-4

    @property
    def height(self):
        return self.resolution[0]

    @property
    def width(self):
        return self.resolution[1]

    @property
    def device(self):
        return self.position.device

    @property
    def viewport_or_full(self):
        if self.viewport is None:
            return (0, 0, self.height, self.width)
        return self.viewport


def _not_ported(what):
    return NotImplementedError(
        f"redner_tpu_torch: {what} is not ported yet (ROADMAP queue A)")


def make_camera(
    position=None,
    look_at=None,
    up=None,
    fov=None,
    clip_near: float = 1e-4,
    resolution: Tuple[int, int] = (256, 256),
    viewport: Optional[Tuple[int, int, int, int]] = None,
    cam_to_world=None,
    intrinsic_mat=None,
    distortion_params=None,
    camera_type: CameraType = CameraType.perspective,
    dtype=torch.float32,
    device=None,
) -> Camera:
    """Build a look-at perspective Camera (pyredner/camera.py:64-125)."""
    if camera_type != CameraType.perspective:
        raise _not_ported(f"camera type {camera_type.name}")
    if cam_to_world is not None or intrinsic_mat is not None:
        raise _not_ported("a camera from cam_to_world/intrinsic_mat")
    if distortion_params is not None:
        raise _not_ported("lens distortion")
    if position is None or look_at is None or up is None or fov is None:
        raise ValueError("make_camera needs position, look_at, up and fov")
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    return Camera(
        position=t(position),
        look_at=t(look_at),
        up=t(up),
        fov=t(fov).reshape(()),
        camera_type=camera_type,
        resolution=tuple(int(r) for r in resolution),
        viewport=tuple(viewport) if viewport is not None else None,
        clip_near=float(clip_near),
    )


def camera_to_world(camera: Camera) -> torch.Tensor:
    """cam_to_world, differentiable through (position, look_at, up)."""
    return xf.look_at_matrix(camera.position, camera.look_at, camera.up)


def intrinsic_mat(camera: Camera) -> torch.Tensor:
    """diag(f, f, 1) with f = 1 / tan(fov / 2) (camera.py:117-123)."""
    fov_factor = 1.0 / torch.tan(xf.radians(0.5 * camera.fov))
    one = torch.ones_like(fov_factor)
    return torch.diag(torch.stack([fov_factor, fov_factor, one]))


def sample_primary(camera: Camera, screen_pos: torch.Tensor) -> Ray:
    """World-space rays for screen positions (..., 2) in [0,1]^2."""
    if camera.camera_type != CameraType.perspective:
        raise _not_ported(f"camera type {camera.camera_type.name}")
    c2w = camera_to_world(camera)
    k_inv = torch.linalg.inv(intrinsic_mat(camera))
    pos = screen_pos
    aspect = camera.width / camera.height
    batch = screen_pos.shape[:-1]
    dtype = screen_pos.dtype
    zero3 = torch.zeros((3,), dtype=dtype, device=screen_pos.device)
    org = xf.xfm_point(c2w, zero3).expand(batch + (3,))
    pt = torch.stack(
        [
            (pos[..., 0] - 0.5) * 2.0,
            (pos[..., 1] - 0.5) * (-2.0) / aspect,
            torch.ones(batch, dtype=dtype, device=screen_pos.device),
        ],
        dim=-1,
    )
    local_dir = vm.normalize(xf.mat3_apply(k_inv, pt))
    world_dir = vm.normalize(xf.xfm_vector(c2w, local_dir))
    return Ray.make(org, world_dir)


def sample_primary_rays(camera: Camera, jitter: torch.Tensor,
                        pixel_order=None):
    """Rays + ray differentials for every viewport pixel.

    jitter: (num_pixels, 2) in [0,1)^2 (0.5 for pixel centers).
    pixel_order: optional (num_pixels,) permutation; lane k generates the
    ray of viewport-flat pixel pixel_order[k].
    Ray differentials follow the reference's finite-difference construction
    with delta=1e-3 and half-pixel scaling (src/camera.cpp:8-43).
    """
    top, left, bottom, right = camera.viewport_or_full
    vw = right - left
    vh = bottom - top
    n = vw * vh
    dtype = jitter.dtype
    if pixel_order is None:
        idx = torch.arange(n, dtype=torch.int64, device=jitter.device)
    else:
        idx = torch.as_tensor(pixel_order, dtype=torch.int64,
                              device=jitter.device)
    px = (idx % vw + left).to(dtype)
    py = (idx // vw + top).to(dtype)
    screen_pos = torch.stack(
        [
            (px + jitter[..., 0]) / camera.width,
            (py + jitter[..., 1]) / camera.height,
        ],
        dim=-1,
    )
    ray = sample_primary(camera, screen_pos)
    delta = 1e-3
    ddx = torch.tensor([delta, 0.0], dtype=dtype, device=jitter.device)
    ddy = torch.tensor([0.0, delta], dtype=dtype, device=jitter.device)
    ray_dx = sample_primary(camera, screen_pos + ddx)
    ray_dy = sample_primary(camera, screen_pos + ddy)
    psx = 0.5 / camera.width
    psy = 0.5 / camera.height
    ray_diff = RayDifferential(
        org_dx=psx * (ray_dx.org - ray.org) / delta,
        org_dy=psy * (ray_dy.org - ray.org) / delta,
        dir_dx=psx * (ray_dx.dir - ray.dir) / delta,
        dir_dy=psy * (ray_dy.dir - ray.dir) / delta,
    )
    return ray, ray_diff


# ------------------------------------------------------------------
# Projection (world point -> screen), needed by primary edge sampling
# (src/camera.h:731-900 `project` / `camera_to_screen`)
# ------------------------------------------------------------------


def camera_to_screen(camera: Camera, pt_cam: torch.Tensor):
    """Camera-space point -> screen [0,1]^2 (+ a validity mask)."""
    if camera.camera_type != CameraType.perspective:
        raise _not_ported(f"camera type {camera.camera_type.name}")
    aspect = camera.width / camera.height
    depth_ok = pt_cam[..., 2] > 0.0
    z = torch.where(depth_ok, pt_cam[..., 2], torch.ones_like(pt_cam[..., 2]))
    proj = xf.mat3_apply(intrinsic_mat(camera), pt_cam / z[..., None])
    x = proj[..., 0] * 0.5 + 0.5
    y = proj[..., 1] * (-0.5) * aspect + 0.5
    return torch.stack([x, y], dim=-1), depth_ok


def project(camera: Camera, p_world: torch.Tensor):
    """World point -> (screen [0,1]^2, clip-plane validity, camera-space
    point); differentiable through the inverse of camera_to_world."""
    w2c = torch.linalg.inv(camera_to_world(camera))
    pt_cam = xf.xfm_point(w2c, p_world)
    screen, valid = camera_to_screen(camera, pt_cam)
    return screen, valid & (pt_cam[..., 2] > camera.clip_near), pt_cam
