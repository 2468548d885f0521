"""User utilities: procedural shapes and quad lights (port of
generate_sphere / generate_quad_light of redner_tpu/utils.py; reference
pyredner/utils.py)."""

from __future__ import annotations

import math

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
