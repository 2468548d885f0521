"""Geometry images of the torch front end (port of
redner_torch/geometry_images.py; reference pyredner/geometry_images.py)."""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.frontend._tensor import _as_int_tensor


def generate_geometry_image(size: int):
    """Regular-grid geometry image -> (vertices, indices int32, uvs) on the
    default device; (2 size + 1)^2 vertices."""
    v, i, uvs = rtt.generate_geometry_image(size,
                                            device=resolve_device(None))
    return v, _as_int_tensor(i), uvs
