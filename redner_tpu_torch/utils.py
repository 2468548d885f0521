"""User utilities: procedural shapes and quad lights, real spherical
harmonics and sRGB conversions (port of redner_tpu/utils.py; reference
pyredner/utils.py)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.material import make_material
from redner_tpu_torch.object import Object


def generate_sphere(theta_steps: int, phi_steps: int, dtype=torch.float32,
                    device=None):
    """UV-sphere (vertices, indices, uvs, normals)
    (reference pyredner/utils.py:63-157)."""
    dev = resolve_device(device)
    d_theta = math.pi / (theta_steps - 1)
    d_phi = (2 * math.pi) / (phi_steps - 1)

    vertices = np.zeros((theta_steps * phi_steps, 3), np.float64)
    uvs = np.zeros((theta_steps * phi_steps, 2), np.float64)
    vertices_index = 0
    for theta_index in range(theta_steps):
        sin_theta = math.sin(theta_index * d_theta)
        cos_theta = math.cos(theta_index * d_theta)
        for phi_index in range(phi_steps):
            sin_phi = math.sin(phi_index * d_phi)
            cos_phi = math.cos(phi_index * d_phi)
            vertices[vertices_index] = (
                sin_theta * cos_phi,
                cos_theta,
                sin_theta * sin_phi,
            )
            uvs[vertices_index] = (
                phi_index * d_phi / (2 * math.pi),
                theta_index * d_theta / math.pi,
            )
            vertices_index += 1

    indices = []
    for theta_index in range(1, theta_steps):
        for phi_index in range(phi_steps - 1):
            id0 = phi_steps * theta_index + phi_index
            id1 = phi_steps * theta_index + phi_index + 1
            id2 = phi_steps * (theta_index - 1) + phi_index
            id3 = phi_steps * (theta_index - 1) + phi_index + 1
            if theta_index < theta_steps - 1:
                indices.append([id0, id2, id1])
            if theta_index > 1:
                indices.append([id1, id2, id3])
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    return (
        t(vertices),
        torch.as_tensor(np.asarray(indices, np.int64), device=dev),
        t(uvs),
        t(vertices.copy()),
    )


def generate_quad_light(position, look_at, size, intensity,
                        directly_visible: bool = True, dtype=torch.float32,
                        device=None):
    """An emissive quad Object facing `look_at`
    (reference pyredner/utils.py:159-210)."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    position, look_at, size, intensity = (
        t(position), t(look_at), t(size), t(intensity))

    d = look_at - position
    z = d / torch.linalg.norm(d)
    up = t([0.0, 1.0, 0.0]) if abs(float(z[1])) <= 0.999 else t([1.0, 0.0, 0.0])
    x = vm.cross(up, z)
    x = x / torch.linalg.norm(x)
    y = vm.cross(z, x)
    hx = 0.5 * size[0]
    hy = 0.5 * size[1]
    verts = torch.stack(
        [
            position - hx * x - hy * y,
            position + hx * x - hy * y,
            position - hx * x + hy * y,
            position + hx * x + hy * y,
        ]
    )
    # Winding so the geometric normal points toward look_at (one-sided
    # emission must face the target; pyredner/utils.py:196-197).
    indices = torch.tensor([[0, 1, 2], [1, 3, 2]], dtype=torch.int64,
                           device=dev)
    mat = make_material(diffuse_reflectance=torch.zeros((3,), dtype=dtype,
                                                        device=dev),
                        device=dev)
    return Object(
        vertices=verts,
        indices=indices,
        material=mat,
        light_intensity=intensity,
        directly_visible=directly_visible,
    )


# ----------------------------------------------------------------------
# Real spherical harmonics (reference pyredner/utils.py:10-62)
# ----------------------------------------------------------------------


def sh_basis(order: int, d):
    """Real SH basis up to band `order` (inclusive) -> (..., (order+1)^2).

    Associated-Legendre recurrences with the Condon-Shortley phase.  Band
    layout: index l*(l+1)+m, m in [-l, l]; the polar axis is +z,
    phi = atan2(y, x); directions are assumed normalized."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    phi = torch.atan2(y, x)
    ct = z
    st = torch.sqrt(vm.maximum(1.0 - ct * ct, 0.0))

    P = {}  # (l, m) -> P_l^m(ct), with the Condon-Shortley phase
    pmm = torch.ones_like(ct)
    for m in range(order + 1):
        if m > 0:
            pmm = pmm * (-(2 * m - 1)) * st  # P_m^m = (-1)^m (2m-1)!! st^m
        P[(m, m)] = pmm
        if m + 1 <= order:
            P[(m + 1, m)] = ct * (2 * m + 1) * P[(m, m)]
        for l in range(m + 2, order + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    out = []
    for l in range(order + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            K = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                out.append(K * P[(l, 0)])
            elif m > 0:
                out.append(math.sqrt(2.0) * K * torch.cos(m * phi) * P[(l, m)])
            else:
                out.append(math.sqrt(2.0) * K * torch.sin(am * phi)
                           * P[(l, am)])
    return torch.stack(out, dim=-1)


def sh_eval(coeffs, dirs):
    """Evaluate SH at directions; the band count is inferred from coeffs.

    coeffs: ((order+1)^2, C) or ((order+1)^2,); dirs: (..., 3) -> (..., C)
    or (...,)."""
    coeffs = torch.as_tensor(coeffs, dtype=dirs.dtype, device=dirs.device)
    n = coeffs.shape[0]
    order = math.isqrt(n) - 1
    if (order + 1) ** 2 != n:
        raise ValueError(
            f"coeffs count {n} is not a square; expected (order+1)^2")
    basis = sh_basis(order, dirs)
    if coeffs.dim() == 1:
        return torch.einsum("...k,k->...", basis, coeffs)
    return torch.einsum("...k,kc->...c", basis, coeffs)


def sh_reconstruct(coeffs, res: Tuple[int, int], dtype=torch.float32,
                   device=None):
    """A lat-long envmap image of size (res[1], res[0]) from SH
    coefficients (reference SH.reconstruct)."""
    dev = (coeffs.device if torch.is_tensor(coeffs) and device is None
           else resolve_device(device))
    h, w = res[1], res[0]
    theta = (torch.arange(h, dtype=dtype, device=dev) + 0.5) / h * math.pi
    phi = (torch.arange(w, dtype=dtype, device=dev) + 0.5) / w * (2.0 * math.pi)
    T, P = torch.meshgrid(theta, phi, indexing="ij")
    st = torch.sin(T)
    d = torch.stack([st * torch.cos(P), torch.cos(T), st * torch.sin(P)],
                    dim=-1)
    return sh_eval(coeffs, d)


def srgb_to_linear(x):
    x = torch.as_tensor(x)
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = vm.clip(torch.as_tensor(x), 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1.0 / 2.4) - 0.055)
