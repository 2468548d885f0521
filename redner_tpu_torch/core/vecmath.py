"""Batched vector math (port of redner_tpu/core/vecmath.py).

All functions operate on tensors whose last axis is the vector dimension
and broadcast over leading (pixel/sample) axes.

Gradient safety: `torch.where` propagates NaN from the untaken branch in
backward exactly as `jnp.where` does, so every singular operation keeps
its double-where guard.
"""

from __future__ import annotations

import torch


def _like(x, ref):
    """A python scalar as a 0-d tensor on ref's dtype/device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def vdot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(length_squared(v))


def distance(a, b):
    return length(a - b)


def luminance(c):
    """Rec.709 luminance (reference: src/vector.h:506-510)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def square(x):
    return x * x


def maximum(a, b):
    """Elementwise max that splits the gradient on ties, as jnp.maximum
    does (torch.clamp passes it all to one side)."""
    if not torch.is_tensor(b):
        b = _like(b, a)
    return torch.maximum(a, b)


def minimum(a, b):
    if not torch.is_tensor(b):
        b = _like(b, a)
    return torch.minimum(a, b)


def clip(x, lo, hi):
    """jnp.clip = min(max(x, lo), hi), with its gradient convention."""
    return minimum(maximum(x, lo), hi)


# ------------------------------------------------------------------
# Gradient-safe singular ops (double-where trick)
# ------------------------------------------------------------------


def safe_div(num, denom, eps=0.0):
    """num / denom that yields 0 (with zero gradient) where |denom| <= eps."""
    ok = torch.abs(denom) > eps
    denom_safe = torch.where(ok, denom, torch.ones_like(denom))
    q = num / denom_safe
    return torch.where(ok, q, torch.zeros_like(q))


def guarded_div(num, denom, eps):
    """num / denom with |denom| clamped away from 0, keeping its sign."""
    sign = torch.where(denom >= 0, 1.0, -1.0).to(denom.dtype)
    mag = maximum(torch.abs(denom), eps)
    return num / (sign * mag)


def safe_sqrt(x):
    """sqrt clamped at 0 with zero gradient at/below 0."""
    ok = x > 0.0
    x_safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, torch.sqrt(x_safe), torch.zeros_like(x))


def safe_rsqrt(x, eps=1e-20):
    ok = x > eps
    x_safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, torch.rsqrt(x_safe), torch.zeros_like(x))


def safe_pow(x, e):
    """x**e safe for x<=0 (returns 0, zero gradient)."""
    ok = x > 0.0
    x_safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, torch.pow(x_safe, e), torch.zeros_like(x_safe))


def normalize(v, return_norm=False):
    """Gradient-safe normalize; returns zeros for (near-)zero vectors."""
    n2 = length_squared(v)
    ok = n2 > 0.0
    n2_safe = torch.where(ok, n2, torch.ones_like(n2))
    inv = torch.where(ok, torch.rsqrt(n2_safe), torch.zeros_like(n2))
    out = v * inv[..., None]
    if return_norm:
        return out, torch.where(ok, torch.sqrt(n2_safe), torch.zeros_like(n2))
    return out


# ------------------------------------------------------------------
# Orthonormal frames
# ------------------------------------------------------------------


def coordinate_system(n):
    """Tangent/bitangent for a normalized n (reference: src/vector.h:532-542),
    branchless Duff et al. construction."""
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    degen = n2 < (-1.0 + 1e-6)
    a = 1.0 / torch.where(degen, torch.ones_like(n2), 1.0 + n2)
    b = -n0 * n1 * a
    x = torch.stack([1.0 - n0 * n0 * a, b, -n0], dim=-1)
    y = torch.stack([b, 1.0 - n1 * n1 * a, -n1], dim=-1)
    x_d = torch.tensor([0.0, -1.0, 0.0], dtype=n.dtype, device=n.device)
    y_d = torch.tensor([-1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    x = torch.where(degen[..., None], x_d, x)
    y = torch.where(degen[..., None], y_d, y)
    return x, y


def to_local(frame_x, frame_y, frame_n, v):
    return torch.stack([dot(v, frame_x), dot(v, frame_y), dot(v, frame_n)],
                       dim=-1)


def to_world(frame_x, frame_y, frame_n, v):
    return (
        frame_x * v[..., 0:1] + frame_y * v[..., 1:2] + frame_n * v[..., 2:3]
    )


def searchsorted_right(sorted_x, q):
    """Per-row count of elements <= q (== searchsorted side="right")."""
    return torch.sum((sorted_x <= q[..., None]).to(torch.int64), dim=-1)
