"""Area lights (port of redner_tpu/light.py; reference src/area_light.h)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from redner_tpu_torch.device import resolve_device


@dataclass
class AreaLight:
    intensity: torch.Tensor  # (3,) differentiable
    shape_id: int = 0
    two_sided: bool = False
    directly_visible: bool = True


def make_area_light(shape_id, intensity, two_sided=False, directly_visible=True,
                    dtype=torch.float32, device=None) -> AreaLight:
    return AreaLight(
        intensity=torch.as_tensor(intensity, dtype=dtype,
                                  device=resolve_device(device)),
        shape_id=int(shape_id),
        two_sided=bool(two_sided),
        directly_visible=bool(directly_visible),
    )
