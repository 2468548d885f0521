"""Texture of the torch front end (port of redner_torch/texture.py;
reference pyredner/texture.py)."""

from __future__ import annotations

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend._tensor import _as_tensor


class Texture:
    """Texels (H, W, C) or a constant (C,), plus a (2,) uv scale.

    Both tensors are differentiable leaves of the render."""

    def __init__(self, texels, uv_scale=None):
        self.texels = _as_tensor(texels)
        self.uv_scale = _as_tensor(
            uv_scale if uv_scale is not None else [1.0, 1.0])

    def _build(self, dev) -> rtt.Texture:
        return rtt.make_texture(self.texels, uv_scale=self.uv_scale,
                                device=dev)
