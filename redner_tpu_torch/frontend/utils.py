"""Scene-building utilities of the torch front end (port of
redner_torch/utils.py; reference pyredner/utils.py)."""

from __future__ import annotations

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.frontend._tensor import _as_int_tensor, _as_tensor
from redner_tpu_torch.frontend.material import Material
from redner_tpu_torch.frontend.object import Object


def generate_sphere(theta_steps: int, phi_steps: int):
    """UV sphere -> (vertices, indices int32, uvs, normals) on the default
    device (reference pyredner/utils.py:63-157)."""
    v, i, uvs, n = rtt.generate_sphere(theta_steps, phi_steps,
                                       device=resolve_device(None))
    return v, _as_int_tensor(i), uvs, n


def generate_quad_light(position, look_at, size, intensity) -> Object:
    """Two-triangle area light facing look_at (reference
    pyredner.generate_quad_light), differentiable w.r.t. its tensors."""
    obj = rtt.generate_quad_light(_as_tensor(position), _as_tensor(look_at),
                                  _as_tensor(size), _as_tensor(intensity),
                                  device=resolve_device(None))
    return Object(vertices=obj.vertices, indices=obj.indices,
                  material=Material(diffuse_reflectance=[0.0, 0.0, 0.0]),
                  light_intensity=obj.light_intensity)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055).pow(2.4)
    )


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.0031308, x * 12.92,
        1.055 * x.clamp_min(1e-12).pow(1.0 / 2.4) - 0.055,
    )


def SH(l, m, theta, phi) -> torch.Tensor:  # noqa: N802, E741
    """Real spherical harmonic Y_l^m at (theta, phi), differentiable
    (reference pyredner/utils.py:34-43)."""
    theta, phi = _as_tensor(theta), _as_tensor(phi)
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return rtt.sh_basis(l, d)[..., l * (l + 1) + m]


def SH_reconstruct(coeffs, res) -> torch.Tensor:  # noqa: N802
    """Lat-long image (res[1], res[0], C) from SH coefficients (C', C)
    (reference pyredner/utils.py:44-62)."""
    return rtt.sh_reconstruct(_as_tensor(coeffs), tuple(res))
