"""Camera of the torch front end (port of redner_torch/camera.py;
reference pyredner/camera.py).

position/look_at/up/fov (or cam_to_world), intrinsic_mat and
distortion_params are differentiable leaves: every render rebuilds the
port's Camera from them with rtt.make_camera, which derives the matrices
with torch ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.camera import CameraType
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.frontend._tensor import _as_tensor


class Camera:
    def __init__(
        self,
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
    ):
        self.position = _as_tensor(position)
        self.look_at = _as_tensor(look_at)
        self.up = _as_tensor(up)
        if fov is None and camera_type == CameraType.perspective \
                and intrinsic_mat is None:
            fov = [45.0]
        self.fov = _as_tensor(fov)
        self.clip_near = float(clip_near)
        self.resolution = tuple(resolution)
        self.viewport = None if viewport is None else tuple(viewport)
        self.cam_to_world = _as_tensor(cam_to_world)
        self.intrinsic_mat = _as_tensor(intrinsic_mat)
        self.distortion_params = _as_tensor(distortion_params)
        self.camera_type = camera_type

    def _build(self, dev) -> rtt.Camera:
        return rtt.make_camera(
            position=self.position, look_at=self.look_at, up=self.up,
            fov=self.fov, clip_near=self.clip_near,
            resolution=self.resolution, viewport=self.viewport,
            cam_to_world=self.cam_to_world,
            intrinsic_mat=self.intrinsic_mat,
            distortion_params=self.distortion_params,
            camera_type=self.camera_type, device=dev,
        )


def automatic_camera_placement(objects, resolution,
                               fov_deg: float = 45.0) -> Camera:
    """A look-at camera that frames the given objects or shapes
    (reference pyredner/camera.py:128); constants, not leaves."""
    cam = rtt.automatic_camera_placement(objects, resolution,
                                         fov_deg=fov_deg)
    return Camera(position=cam.position.detach(),
                  look_at=cam.look_at.detach(), up=cam.up.detach(),
                  fov=[fov_deg], resolution=resolution)


def generate_intrinsic_mat(fx, fy, skew, x0, y0) -> torch.Tensor:
    """3x3 intrinsic matrix, differentiable through any tensor argument
    (reference pyredner/camera.py:234-268)."""
    return rtt.generate_intrinsic_mat(fx, fy, skew, x0, y0,
                                      device=resolve_device(None))
