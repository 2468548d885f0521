"""Homogeneous transforms and matrix generators (port of
redner_tpu/core/transform.py).

These apply ONE small matrix to batched points, written as explicit
elementwise multiply-adds rather than matmuls: exact f32 whatever the
backend's matmul precision, and a K=4 product gains nothing from a GEMM.
"""

from __future__ import annotations

import math

import torch

from redner_tpu_torch.core import vecmath as vm


def xfm_point(m, p):
    """Apply a 4x4 matrix to points (..., 3) with perspective divide."""
    lin = (
        p[..., 0:1] * m[:3, 0] + p[..., 1:2] * m[:3, 1]
        + p[..., 2:3] * m[:3, 2] + m[:3, 3]
    )
    w = (
        p[..., 0:1] * m[3:4, 0] + p[..., 1:2] * m[3:4, 1]
        + p[..., 2:3] * m[3:4, 2] + m[3:4, 3]
    )
    return lin / w


def xfm_vector(m, v):
    """Apply the linear part of a 4x4 (or 3x3) matrix to vectors."""
    return (
        v[..., 0:1] * m[:3, 0] + v[..., 1:2] * m[:3, 1]
        + v[..., 2:3] * m[:3, 2]
    )


def mat3_apply(m, v):
    return (
        v[..., 0:1] * m[:3, 0] + v[..., 1:2] * m[:3, 1]
        + v[..., 2:3] * m[:3, 2]
    )


def look_at_matrix(pos, look, up):
    """Camera-to-world matrix (reference: src/transform.h:9-27).

    Columns are (right, up, forward, position); forward = normalize(look-pos).
    """
    d = vm.normalize(look - pos)
    right = vm.normalize(vm.cross(d, vm.normalize(up)))
    new_up = vm.normalize(vm.cross(right, d))
    m = torch.stack([right, new_up, d, pos], dim=-1)  # (3, 4)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=m.dtype,
                          device=m.device)
    return torch.cat([m, bottom], dim=0)


def gen_translate_matrix(t):
    m = torch.eye(4, dtype=t.dtype, device=t.device)
    return torch.cat([torch.cat([m[:3, :3], t[:, None]], dim=1), m[3:]], dim=0)


def gen_scale_matrix(s):
    return torch.diag(torch.cat([s, torch.ones_like(s[:1])]))


def gen_rotate_matrix(angles):
    """Euler XYZ rotation matrix, 4x4 (pyredner/transform.py:44-77 parity)."""
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)
    rx = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, cx, -sx]),
        torch.stack([zero, sx, cx]),
    ])
    ry = torch.stack([
        torch.stack([cy, zero, sy]),
        torch.stack([zero, one, zero]),
        torch.stack([-sy, zero, cy]),
    ])
    rz = torch.stack([
        torch.stack([cz, -sz, zero]),
        torch.stack([sz, cz, zero]),
        torch.stack([zero, zero, one]),
    ])
    r = rz @ ry @ rx
    top = torch.cat([r, torch.zeros_like(r[:, :1])], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype,
                          device=r.device)
    return torch.cat([top, bottom], dim=0)


def gen_perspective_matrix(fov_deg, clip_near, clip_far):
    """Perspective projection matrix (pyredner/transform.py:34-42 parity)."""
    fov = torch.as_tensor(fov_deg, dtype=torch.float32) * (math.pi / 180.0)
    cot = 1.0 / torch.tan(fov / 2.0)
    clip_dist = clip_far - clip_near
    m = torch.zeros((4, 4), dtype=cot.dtype, device=cot.device)
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = 1.0 / clip_dist
    m[2, 3] = -clip_near / clip_dist
    m[3, 2] = 1.0
    return m


def radians(deg):
    return deg * (math.pi / 180.0)
