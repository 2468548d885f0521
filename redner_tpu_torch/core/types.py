"""Core value types shared across the renderer (port of
redner_tpu/core/types.py).

Structure-of-arrays structs: every field is a batched tensor whose leading
axes index pixels/samples.  Plain dataclasses; `dataclasses.replace` takes
the place of flax's `.replace`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Ray:
    """A batch of rays (reference: src/ray.h)."""

    org: torch.Tensor  # (..., 3)
    dir: torch.Tensor  # (..., 3)
    tmin: torch.Tensor  # (...,)
    tmax: torch.Tensor  # (...,)

    @classmethod
    def make(cls, org, dir, tmin=None, tmax=None):  # noqa: A002
        batch = org.shape[:-1]
        kw = dict(dtype=org.dtype, device=org.device)
        tmin = (torch.zeros(batch, **kw) if tmin is None
                else torch.as_tensor(tmin, **kw).expand(batch))
        tmax = (torch.full(batch, float("inf"), **kw) if tmax is None
                else torch.as_tensor(tmax, **kw).expand(batch))
        return cls(org=org, dir=dir.expand(org.shape), tmin=tmin, tmax=tmax)


@dataclass
class RayDifferential:
    """Screen-space ray differentials (reference: src/ray.h RayDifferential)."""

    org_dx: torch.Tensor  # (..., 3)
    org_dy: torch.Tensor
    dir_dx: torch.Tensor
    dir_dy: torch.Tensor

    @classmethod
    def zero(cls, batch_shape, dtype=torch.float32, device=None):
        z = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return cls(org_dx=z, org_dy=z, dir_dx=z, dir_dy=z)


@dataclass
class Intersection:
    """Hit records: flat triangle id into the flattened scene, plus shape id.
    A miss is tri_id == -1."""

    tri_id: torch.Tensor  # (...,) int64, -1 == miss
    shape_id: torch.Tensor  # (...,) int64, -1 == miss
    t: torch.Tensor  # (...,) hit distance (detached; recomputed for AD)

    @property
    def valid(self):
        return self.tri_id >= 0


@dataclass
class SurfacePoint:
    """Differential surface point (reference: src/intersection.h:21-53)."""

    position: torch.Tensor  # (..., 3)
    geom_normal: torch.Tensor  # (..., 3)
    frame_x: torch.Tensor  # (..., 3) shading frame tangent
    frame_y: torch.Tensor  # (..., 3) shading frame bitangent
    frame_n: torch.Tensor  # (..., 3) shading normal
    dpdu: torch.Tensor  # (..., 3)
    uv: torch.Tensor  # (..., 2)
    du_dxy: torch.Tensor  # (..., 2) texture-footprint derivatives
    dv_dxy: torch.Tensor  # (..., 2)
    dn_dx: torch.Tensor  # (..., 3) shading-normal screen derivatives
    dn_dy: torch.Tensor  # (..., 3)
    color: torch.Tensor  # (..., 3) interpolated vertex color
    barycentric: torch.Tensor  # (..., 2)
