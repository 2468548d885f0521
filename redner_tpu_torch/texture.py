"""Textures (port of the constant-texture path of redner_tpu/texture.py).

A constant texture is a (C,) tensor.  Image textures with mipmaps and the
MaterialBank are not ported yet: building a material from an (H, W, C)
texture raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from redner_tpu_torch.device import resolve_device


@dataclass
class Texture:
    """User-facing texture: base texels + uv scale (pyredner/texture.py)."""

    texels: torch.Tensor  # (C,) for a constant
    uv_scale: torch.Tensor  # (2,)

    @property
    def is_constant(self):
        return self.texels.dim() == 1

    @property
    def channels(self):
        return self.texels.shape[-1]


def make_texture(texels, uv_scale=None, dtype=torch.float32,
                 device=None) -> Texture:
    dev = resolve_device(device)
    texels = torch.as_tensor(texels, dtype=dtype, device=dev)
    if uv_scale is None:
        uv_scale = torch.ones((2,), dtype=dtype, device=dev)
    else:
        uv_scale = torch.as_tensor(uv_scale, dtype=dtype, device=dev)
    return Texture(texels=texels, uv_scale=uv_scale)


@dataclass
class PackedTexture:
    """A texture ready for per-lane fetches; constant textures only."""

    flat: torch.Tensor  # (1, C)
    uv_scale: torch.Tensor  # (2,)

    @property
    def channels(self):
        return self.flat.shape[-1]


def pack_texture(tex: Texture) -> PackedTexture:
    """Flatten a texture (differentiable w.r.t. tex.texels)."""
    if not tex.is_constant:
        raise NotImplementedError(
            "redner_tpu_torch: image textures (mipmaps, MaterialBank) are "
            "not ported yet (ROADMAP queue A)")
    return PackedTexture(flat=tex.texels[None, :], uv_scale=tex.uv_scale)
