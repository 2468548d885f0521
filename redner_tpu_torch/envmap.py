"""Environment map (lat-long) lighting: evaluation, importance sampling,
pdf (port of redner_tpu/envmap.py; reference src/envmap.h:62-306,
pyredner/envmap.py:36-60).

The luminance CDF tables are built from the texels and detached (the
reference returns no gradients for the CDFs or pdf_norm, SURVEY A.3);
gradients reach the envmap through `envmap_eval`'s texture fetch and the two
transforms.  `env_to_world` and `world_to_env` are two separate leaves, as
in the JAX package: the inverse is taken once, when the map is made, and
carries no gradient back to `env_to_world`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from redner_tpu_torch.core import transform as xf
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import RayDifferential
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.texture import (PackedTexture, Texture, make_texture,
                                      pack_texture, texture_eval)

PI = math.pi


@dataclass
class EnvironmentMap:
    """User-facing environment map (pyredner/envmap.py)."""

    values: Texture  # (H, W, 3) base texels
    env_to_world: torch.Tensor  # (4, 4)
    world_to_env: torch.Tensor  # (4, 4)
    directly_visible: bool = True


def make_environment_map(values, env_to_world=None, directly_visible=True,
                         dtype=torch.float32, device=None) -> EnvironmentMap:
    if isinstance(values, Texture):
        dev = values.texels.device
    else:
        dev = resolve_device(device)
        values = make_texture(values, dtype=dtype, device=dev)
    if env_to_world is None:
        env_to_world = torch.eye(4, dtype=dtype, device=dev)
    else:
        env_to_world = torch.as_tensor(env_to_world, dtype=dtype, device=dev)
    return EnvironmentMap(
        values=values,
        env_to_world=env_to_world,
        world_to_env=torch.linalg.inv(env_to_world.detach()),
        directly_visible=bool(directly_visible),
    )


@dataclass
class PackedEnvmap:
    """Render-ready envmap: packed mipmap + sampling CDFs."""

    ptex: PackedTexture
    env_to_world: torch.Tensor
    world_to_env: torch.Tensor
    sample_cdf_xs: torch.Tensor  # (H, W) per-row conditional CDF
    sample_cdf_ys: torch.Tensor  # (H,) marginal CDF
    pdf_norm: torch.Tensor  # ()
    base_luminance: torch.Tensor  # (H, W) luminance of level 0, detached
    directly_visible: bool = True

    @property
    def base_width(self):
        return self.ptex.widths[0]

    @property
    def base_height(self):
        return self.ptex.heights[0]


def pack_envmap(env: EnvironmentMap) -> PackedEnvmap:
    """CDF tables (pyredner/envmap.py:36-60 math) + packed mipmap."""
    texels = env.values.texels
    if texels.dim() != 3:
        raise ValueError("environment map must be an (H, W, C) image")
    with torch.no_grad():
        lum = vm.luminance(texels)
        h, w = lum.shape
        cdf_xs_raw = torch.cumsum(lum, dim=1)
        y_weight = torch.sin(
            PI * (torch.arange(h, dtype=texels.dtype, device=texels.device)
                  + 0.5) / float(h))
        cdf_ys_raw = vm.cumsum(cdf_xs_raw[:, -1] * y_weight, dim=0)
        pdf_norm = (h * w) / (cdf_ys_raw[-1] * (2.0 * PI * PI))
        cdf_xs = (cdf_xs_raw - cdf_xs_raw[:, :1]) / torch.clamp(
            cdf_xs_raw[:, -1:], min=1e-8)
        cdf_ys = (cdf_ys_raw - cdf_ys_raw[0]) / torch.clamp(
            cdf_ys_raw[-1], min=1e-8)
    return PackedEnvmap(
        ptex=pack_texture(env.values),
        env_to_world=env.env_to_world,
        world_to_env=env.world_to_env,
        sample_cdf_xs=cdf_xs,
        sample_cdf_ys=cdf_ys,
        pdf_norm=pdf_norm,
        base_luminance=lum,
        directly_visible=env.directly_visible,
    )


def _safe_acos(x):
    # Strictly inside [-1, 1]: d(acos)/dx diverges at the boundary and the
    # infinite derivative leaks through later wheres at the poles.
    return torch.arccos(vm.clip(x, -1.0 + 1e-6, 1.0 - 1e-6))


def _dir_to_uv(local_dir):
    """Spherical (lat-long) parameterization, y up (src/envmap.h:66-72)."""
    u = torch.atan2(local_dir[..., 0], -local_dir[..., 2]) / (2.0 * PI)
    v = _safe_acos(local_dir[..., 1]) / PI
    return torch.stack([u, v], dim=-1)


def envmap_eval(penv: PackedEnvmap, dir, ray_diff: RayDifferential):  # noqa: A002
    """Radiance from direction(s) with mip filtering (src/envmap.h:64-100)."""
    local_dir = vm.normalize(xf.xfm_vector(penv.world_to_env, dir))
    uv = _dir_to_uv(local_dir)
    ldx = xf.xfm_vector(penv.world_to_env, ray_diff.dir_dx)
    ldy = xf.xfm_vector(penv.world_to_env, ray_diff.dir_dy)
    x2z2 = vm.square(local_dir[..., 0]) + vm.square(local_dir[..., 2])
    x2z2_ok = x2z2 > 1e-12
    x2z2s = torch.where(x2z2_ok, x2z2, torch.ones_like(x2z2))
    du_dx_ = local_dir[..., 0] / (2.0 * PI * x2z2s)
    du_dz_ = local_dir[..., 2] / (2.0 * PI * x2z2s)
    du_dxy = torch.stack(
        [du_dx_ * ldx[..., 0] + du_dz_ * ldx[..., 2],
         du_dx_ * ldy[..., 0] + du_dz_ * ldy[..., 2]], dim=-1)
    one_m_y2 = 1.0 - vm.square(local_dir[..., 1])
    y_ok = one_m_y2 > 1e-12
    dv_dy_ = -1.0 / (PI * torch.sqrt(torch.where(y_ok, one_m_y2,
                                                 torch.ones_like(one_m_y2))))
    dv_dxy = torch.stack([dv_dy_ * ldx[..., 1], dv_dy_ * ldy[..., 1]], dim=-1)
    singular = ~(x2z2_ok & y_ok)[..., None]
    du_dxy = torch.where(singular, torch.zeros_like(du_dxy), du_dxy)
    dv_dxy = torch.where(singular, torch.zeros_like(dv_dxy), dv_dxy)
    return texture_eval(penv.ptex, uv, du_dxy, dv_dxy)


def _tent_inv_cdf(x):
    """Inverse CDF of the tent filter (src/envmap.h:203-210):
    x < 0.5 -> 1 - sqrt(2x);  else sqrt(2x - 0.5) - 1."""
    lo = 1.0 - vm.safe_sqrt(2.0 * x)
    hi = vm.safe_sqrt(vm.maximum(2.0 * x - 0.5, 0.0)) - 1.0
    return torch.where(x < 0.5, lo, hi)


def envmap_sample(penv: PackedEnvmap, sample):
    """Importance-sample a direction (src/envmap.h:212-246).

    sample: (..., 2) uniforms.  Returns world-space directions (..., 3)."""
    h = penv.base_height
    w = penv.base_width
    sx = sample[..., 0]
    sy = sample[..., 1]
    cdf_ys = penv.sample_cdf_ys
    y_pos = torch.clamp(vm.searchsorted_right(cdf_ys, sy) - 1, 0, h - 1)
    cdf_y0 = cdf_ys[y_pos]
    cdf_y1 = torch.where(y_pos < h - 1,
                         cdf_ys[torch.clamp(y_pos + 1, max=h - 1)],
                         torch.ones_like(cdf_y0))
    sy = vm.safe_div(sy - cdf_y0, cdf_y1 - cdf_y0)
    row_cdf = penv.sample_cdf_xs[y_pos]  # (..., W)
    x_pos = torch.clamp(vm.searchsorted_right(row_cdf, sx) - 1, 0, w - 1)
    cdf_x0 = torch.gather(row_cdf, -1, x_pos[..., None])[..., 0]
    cdf_x1 = torch.where(
        x_pos < w - 1,
        torch.gather(row_cdf, -1,
                     torch.clamp(x_pos + 1, max=w - 1)[..., None])[..., 0],
        torch.ones_like(cdf_x0))
    sx = vm.safe_div(sx - cdf_x0, cdf_x1 - cdf_x0)
    u = x_pos.to(sample.dtype) + _tent_inv_cdf(sx)
    v = y_pos.to(sample.dtype) + _tent_inv_cdf(sy)
    phi = (2.0 * PI / w) * (u + 0.5)
    theta = (PI / h) * (v + 0.5)
    sp, cp = torch.sin(phi), torch.cos(phi)
    st, ct = torch.sin(theta), torch.cos(theta)
    local_dir = torch.stack([sp * st, ct, -cp * st], dim=-1)
    return xf.xfm_vector(penv.env_to_world, local_dir)


def envmap_pdf(penv: PackedEnvmap, dir):  # noqa: A002
    """Solid-angle pdf of envmap_sample (src/envmap.h:249-306)."""
    h = penv.base_height
    w = penv.base_width
    local_dir = xf.xfm_vector(penv.world_to_env, dir)
    uv = _dir_to_uv(vm.normalize(local_dir))
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    xfi = torch.remainder(torch.floor(x).to(torch.int64), w)
    yfi = torch.remainder(torch.floor(y).to(torch.int64), h)
    xci = torch.remainder(xfi + 1, w)
    yci = torch.remainder(yfi + 1, h)
    dx = torch.remainder(x - torch.floor(x), 1.0)
    dy = torch.remainder(y - torch.floor(y), 1.0)
    lum = penv.base_luminance.reshape(-1)

    def tap(yi, xi):
        return lum.index_select(0, (yi * w + xi).reshape(-1)).reshape(
            yi.shape)

    lum_fy = tap(yfi, xfi) * (1 - dx) * (1 - dy) + tap(yfi, xci) * dx * (1 - dy)
    lum_cy = tap(yci, xfi) * (1 - dx) * dy + tap(yci, xci) * dx * dy
    nl = vm.normalize(local_dir)
    sin_theta = vm.safe_sqrt(1.0 - vm.square(nl[..., 1]))
    ok = sin_theta > 0
    sin_fy = torch.abs(torch.sin(PI * (yfi.to(x.dtype) + 0.5) / h))
    sin_cy = torch.abs(torch.sin(PI * (yci.to(x.dtype) + 0.5) / h))
    pdf = penv.pdf_norm * torch.abs(lum_fy * sin_fy + lum_cy * sin_cy) \
        / torch.where(ok, sin_theta, torch.ones_like(sin_theta))
    return torch.where(ok, pdf, torch.zeros_like(pdf))
