"""Camera models: perspective, orthographic, fisheye (equi-angular) and
panorama, with optional Brown-Conrady lens distortion (port of
redner_tpu/camera.py; reference src/camera.h:122-197,
src/camera_distortion.h:7-80,173-198, pyredner/camera.py).

Conventions (identical to the reference):
  * screen space is [0,1]^2 with x right, y down;
  * film plane mapping: [0,1]^2 -> [-1,1] x [1,-1]/aspect, aspect = W/H;
  * cam_to_world columns are (right, up, forward, position);
  * the local forward axis is +z.

The camera holds make_camera's differentiable inputs under the JAX
package's field names: position/look_at/up in look-at mode, cam_to_world
otherwise; intrinsic_mat; distortion_params.  The inverses (world_to_cam,
the inverse intrinsic matrix) and fov are derived on every call, so
autograd reaches the leaves and no stale inverse can exist.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from redner_tpu_torch.core import transform as xf
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.core.types import Ray, RayDifferential
from redner_tpu_torch.device import resolve_device


class CameraType(enum.Enum):
    perspective = 0
    orthographic = 1
    fisheye = 2
    panorama = 3


@dataclass
class Camera:
    position: Optional[torch.Tensor]  # (3,), look-at mode only
    look_at: Optional[torch.Tensor]  # (3,), look-at mode only
    up: Optional[torch.Tensor]  # (3,), look-at mode only
    cam_to_world: Optional[torch.Tensor]  # (4, 4), when not use_look_at
    intrinsic_mat: torch.Tensor  # (3, 3)
    distortion_params: torch.Tensor  # (8,) k1..k6, p1, p2
    use_look_at: bool = True
    # Gates the distortion math: a camera built without distortion whose
    # distortion_params are replaced must also set has_distortion=True.
    has_distortion: bool = False
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
        return self.intrinsic_mat.device

    @property
    def viewport_or_full(self):
        if self.viewport is None:
            return (0, 0, self.height, self.width)
        return self.viewport

    @property
    def fov(self):
        """fov (degrees) recovered from the intrinsic matrix."""
        return torch.atan(1.0 / self.intrinsic_mat[0, 0]) * (360.0 / math.pi)


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
    """Build a Camera (pyredner/camera.py:64-125): look-at mode from
    position/look_at/up, or from a 4x4 cam_to_world; the intrinsic matrix
    given, else diag(f, f, 1) with f = 1 / tan(fov / 2) for a perspective
    camera and the identity for the other types."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    use_look_at = cam_to_world is None
    if use_look_at:
        if position is None or look_at is None or up is None:
            raise ValueError("make_camera needs position, look_at and up, or "
                             "cam_to_world")
        position, look_at, up = t(position), t(look_at), t(up)
        c2w = None
    else:
        position = look_at = up = None
        c2w = t(cam_to_world)
    if intrinsic_mat is None:
        if camera_type == CameraType.perspective:
            if fov is None:
                raise ValueError("a perspective camera needs fov or "
                                 "intrinsic_mat")
            fov_factor = 1.0 / torch.tan(xf.radians(0.5 * t(fov).reshape(())))
            one = torch.ones_like(fov_factor)
            intrinsic_mat = torch.diag(torch.stack([fov_factor, fov_factor,
                                                    one]))
        else:
            intrinsic_mat = torch.eye(3, dtype=dtype, device=dev)
    else:
        intrinsic_mat = t(intrinsic_mat)
    has_distortion = distortion_params is not None
    distortion_params = (torch.zeros((8,), dtype=dtype, device=dev)
                         if distortion_params is None
                         else t(distortion_params))
    return Camera(
        position=position,
        look_at=look_at,
        up=up,
        cam_to_world=c2w,
        intrinsic_mat=intrinsic_mat,
        distortion_params=distortion_params,
        use_look_at=use_look_at,
        has_distortion=has_distortion,
        camera_type=camera_type,
        resolution=tuple(int(r) for r in resolution),
        viewport=tuple(viewport) if viewport is not None else None,
        clip_near=float(clip_near),
    )


def camera_to_world(camera: Camera) -> torch.Tensor:
    """cam_to_world, differentiable through (position, look_at, up) in
    look-at mode."""
    if camera.use_look_at:
        return xf.look_at_matrix(camera.position, camera.look_at, camera.up)
    return camera.cam_to_world


def _inv(m):
    """torch.linalg.inv without its singularity check, which reads the
    factorization's status on the host (a sync on a card)."""
    return torch.linalg.inv_ex(m).inverse


def world_to_cam(camera: Camera) -> torch.Tensor:
    return _inv(camera_to_world(camera))


# ------------------------------------------------------------------
# Brown-Conrady distortion (src/camera_distortion.h:19-84)
# ------------------------------------------------------------------


def _distort_terms(params, pos):
    k = params[:6]
    p = params[6:8]
    x = 2.0 * (pos[..., 0] - 0.5)
    y = 2.0 * (pos[..., 1] - 0.5)
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k[0] * r2 + k[1] * r4 + k[2] * r6
    den = 1.0 + k[3] * r2 + k[4] * r4 + k[5] * r6
    return k, p, x, y, r2, r4, num, den


def distort(params: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The rational Brown-Conrady model on screen positions (..., 2)."""
    _, p, x, y, r2, _, num, den = _distort_terms(params, pos)
    rr = num / den
    xx = x * rr + 2.0 * p[0] * x * y + p[1] * (r2 + 2.0 * x * x)
    yy = y * rr + p[0] * (r2 + 2.0 * y * y) + 2.0 * p[1] * x * y
    return torch.stack([(xx + 1.0) * 0.5, (yy + 1.0) * 0.5], dim=-1)


def _newton_step(params, res, pos):
    """One Gauss-Newton step of distort(params, res) = pos, with the 2x2
    screen Jacobian of distort written out (the JAX package takes it from
    two jvps; the same derivative)."""
    k, p, x, y, r2, r4, num, den = _distort_terms(params, res)
    rr = num / den
    dnum = k[0] + 2.0 * k[1] * r2 + 3.0 * k[2] * r4
    dden = k[3] + 2.0 * k[4] * r2 + 3.0 * k[5] * r4
    drr = (dnum * den - num * dden) / (den * den)  # d rr / d r2
    # d(screen)/d(screen): the 0.5 of the output and the 2 of x cancel;
    # the Jacobian is symmetric (jxy = d out_x / d y = d out_y / d x).
    jxx = rr + 2.0 * x * x * drr + 2.0 * p[0] * y + 6.0 * p[1] * x
    jxy = 2.0 * x * y * drr + 2.0 * p[0] * x + 2.0 * p[1] * y
    jyy = rr + 2.0 * y * y * drr + 6.0 * p[0] * y + 2.0 * p[1] * x
    residual = distort(params, res) - pos
    rx, ry = residual[..., 0], residual[..., 1]
    det = jxx * jyy - jxy * jxy
    # Sign-preserving det floor: near a fold of the model det -> 0, and a
    # raw 1/det would overflow the implicit-function derivative.
    inv_det = vm.guarded_div(torch.ones_like(det), det, 1e-6)
    dx = inv_det * (jyy * rx - jxy * ry)
    dy = inv_det * (-jxy * rx + jxx * ry)
    return res - torch.stack([dx, dy], dim=-1)


def inverse_distort(params: torch.Tensor, pos: torch.Tensor,
                    n_iters: int = 20) -> torch.Tensor:
    """Invert `distort` by Gauss-Newton (src/camera_distortion.h:173-198).

    The iterations run on detached values (no backward or forward-mode
    derivative); every iterate is clamped to [-10, 11] with NaN mapped to
    0, so a lane whose inverse does not exist cannot poison the gradient.
    One final differentiable step (implicit function theorem) gives the
    first-order sensitivities to both `pos` and `params`."""
    fixed_params = params.detach()
    fixed_pos = pos.detach()
    result = fixed_pos
    for _ in range(n_iters):
        result = torch.clamp(torch.nan_to_num(
            _newton_step(fixed_params, result, fixed_pos)), -10.0, 11.0)
    return _newton_step(params, result, pos)


def _maybe_inverse_distort(camera: Camera, screen_pos):
    if camera.has_distortion:
        return inverse_distort(camera.distortion_params, screen_pos)
    return screen_pos


# ------------------------------------------------------------------
# Primary ray generation (src/camera.h:122-197, src/camera.cpp:8-43)
# ------------------------------------------------------------------


def sample_primary(camera: Camera, screen_pos: torch.Tensor) -> Ray:
    """World-space rays for screen positions (..., 2) in [0,1]^2.  Fisheye
    lanes outside the image circle get a zero direction: a dead lane."""
    c2w = camera_to_world(camera)
    pos = _maybe_inverse_distort(camera, screen_pos)
    aspect = camera.width / camera.height
    batch = screen_pos.shape[:-1]
    dtype, dev = screen_pos.dtype, screen_pos.device
    zero3 = torch.zeros((3,), dtype=dtype, device=dev)
    ct = camera.camera_type
    if ct == CameraType.orthographic:
        pt = torch.stack([
            (pos[..., 0] - 0.5) * 2.0,
            (pos[..., 1] - 0.5) * (-2.0) / aspect,
            torch.zeros(batch, dtype=dtype, device=dev),
        ], dim=-1)
        org = xf.xfm_point(c2w, xf.mat3_apply(
            _inv(camera.intrinsic_mat), pt))
        d = vm.normalize(xf.xfm_vector(
            c2w, const((0.0, 0.0, 1.0), dtype, dev)))
        return Ray.make(org, d.expand(org.shape))
    org = xf.xfm_point(c2w, zero3).expand(batch + (3,))
    if ct == CameraType.perspective:
        pt = torch.stack([
            (pos[..., 0] - 0.5) * 2.0,
            (pos[..., 1] - 0.5) * (-2.0) / aspect,
            torch.ones(batch, dtype=dtype, device=dev),
        ], dim=-1)
        local_dir = vm.normalize(xf.mat3_apply(
            _inv(camera.intrinsic_mat), pt))
        return Ray.make(org, vm.normalize(xf.xfm_vector(c2w, local_dir)))
    if ct == CameraType.fisheye:
        x = 2.0 * (pos[..., 0] - 0.5)
        y = 2.0 * (pos[..., 1] - 0.5)
        r2 = x * x + y * y
        inside = r2 <= 1.0
        r = vm.safe_sqrt(r2)
        phi = torch.atan2(y, torch.where(torch.abs(x) + torch.abs(y) > 0, x,
                                         torch.ones_like(x)))
        theta = r * (math.pi / 2.0)
        st = torch.sin(theta)
        local_dir = torch.stack([-torch.cos(phi) * st, -torch.sin(phi) * st,
                                 torch.cos(theta)], dim=-1)
        world_dir = vm.normalize(xf.xfm_vector(c2w, local_dir))
        # Outside the image circle (the reference drops these lanes,
        # src/camera.h:160-163).
        world_dir = torch.where(inside[..., None], world_dir,
                                torch.zeros_like(world_dir))
        return Ray.make(org, world_dir)
    if ct == CameraType.panorama:
        theta = math.pi * pos[..., 1]
        phi = 2.0 * math.pi * pos[..., 0]
        st = torch.sin(theta)
        local_dir = torch.stack([torch.cos(phi) * st, torch.cos(theta),
                                 torch.sin(phi) * st], dim=-1)
        return Ray.make(org, vm.normalize(xf.xfm_vector(c2w, local_dir)))
    raise ValueError(f"unknown camera type {ct}")


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
    ddx = const((delta, 0.0), dtype, jitter.device)
    ddy = const((0.0, delta), dtype, jitter.device)
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
    aspect = camera.width / camera.height
    ct = camera.camera_type
    valid = torch.ones(pt_cam.shape[:-1], dtype=torch.bool,
                       device=pt_cam.device)
    if ct in (CameraType.perspective, CameraType.orthographic):
        proj_in = pt_cam
        if ct == CameraType.perspective:
            valid = pt_cam[..., 2] > 0.0
            z = torch.where(valid, pt_cam[..., 2],
                            torch.ones_like(pt_cam[..., 2]))
            proj_in = pt_cam / z[..., None]
        proj = xf.mat3_apply(camera.intrinsic_mat, proj_in)
        screen = torch.stack([proj[..., 0] * 0.5 + 0.5,
                              proj[..., 1] * (-0.5) * aspect + 0.5], dim=-1)
    elif ct == CameraType.fisheye:
        d = vm.normalize(pt_cam)
        theta = torch.arccos(torch.clamp(d[..., 2], -1.0 + 1e-6, 1.0 - 1e-6))
        r = theta * 2.0 / math.pi
        phi = torch.atan2(-d[..., 1], -d[..., 0])
        screen = torch.stack([0.5 * (r * torch.cos(phi) + 1.0),
                              0.5 * (r * torch.sin(phi) + 1.0)], dim=-1)
    elif ct == CameraType.panorama:
        d = vm.normalize(pt_cam)
        theta = torch.arccos(torch.clamp(d[..., 1], -1.0 + 1e-6, 1.0 - 1e-6))
        phi = torch.atan2(d[..., 2], d[..., 0])
        phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
        screen = torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)
    else:
        raise ValueError(f"unknown camera type {ct}")
    if camera.has_distortion:
        screen = distort(camera.distortion_params, screen)
    return screen, valid


def project(camera: Camera, p_world: torch.Tensor):
    """World point -> (screen [0,1]^2, validity, camera-space point);
    differentiable through world_to_cam.  Perspective and orthographic
    points nearer than clip_near are invalid."""
    pt_cam = xf.xfm_point(world_to_cam(camera), p_world)
    screen, valid = camera_to_screen(camera, pt_cam)
    if camera.camera_type in (CameraType.perspective,
                              CameraType.orthographic):
        valid = valid & (pt_cam[..., 2] > camera.clip_near)
    return screen, valid, pt_cam


# ------------------------------------------------------------------
# Camera utilities (pyredner/camera.py:193-268)
# ------------------------------------------------------------------


def automatic_camera_placement(shapes, resolution, fov_deg=45.0,
                               dtype=torch.float32) -> Camera:
    """A look-at camera on the -z side that frames all given shapes or
    objects (pyredner.automatic_camera_placement, pyredner/camera.py:193-233);
    on the device of their vertices."""
    allv = torch.cat([torch.as_tensor(s.vertices) for s in shapes],
                     dim=0).to(dtype)
    vmin = torch.min(allv, dim=0).values
    vmax = torch.max(allv, dim=0).values
    center = 0.5 * (vmin + vmax)
    radius = 0.5 * float(torch.max(vmax - vmin)) + 1e-6
    fov = torch.as_tensor(fov_deg, dtype=dtype, device=allv.device)
    distance = radius / torch.tan(xf.radians(0.5 * fov)) * 2.0
    direction = torch.tensor([0.0, 0.0, -1.0], dtype=dtype,
                             device=allv.device)
    return make_camera(
        position=center + direction * distance,
        look_at=center,
        up=torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=allv.device),
        fov=fov,
        resolution=resolution,
        dtype=dtype,
        device=allv.device,
    )


def generate_intrinsic_mat(fx, fy, skew, x0, y0, dtype=torch.float32,
                           device=None):
    """3x3 intrinsic matrix from the five standard parameters
    (pyredner.generate_intrinsic_mat, pyredner/camera.py:234-268);
    differentiable through any of them given as tensors."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    fx, fy, skew, x0, y0 = t(fx), t(fy), t(skew), t(x0), t(y0)
    z = torch.zeros((), dtype=dtype, device=dev)
    o = torch.ones((), dtype=dtype, device=dev)
    return torch.stack([
        torch.stack([fx, skew, x0]),
        torch.stack([z, fy, y0]),
        torch.stack([z, z, o]),
    ])
