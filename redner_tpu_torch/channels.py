"""AOV channel system (port of redner_tpu/channels.py; reference
src/channels.h:6-23, src/channels.cpp:6-40).

Channels select what the renderer writes per pixel; `ChannelInfo` computes
the packed per-pixel layout and the offset of the radiance channel.
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple


class Channels(enum.Enum):
    radiance = 0
    alpha = 1
    depth = 2
    position = 3
    geometry_normal = 4
    shading_normal = 5
    uv = 6
    barycentric_coordinates = 7
    diffuse_reflectance = 8
    specular_reflectance = 9
    roughness = 10
    generic_texture = 11
    vertex_color = 12
    shape_id = 13
    triangle_id = 14
    material_id = 15


_FIXED_DIMS = {
    Channels.radiance: 3,
    Channels.alpha: 1,
    Channels.depth: 1,
    Channels.position: 3,
    Channels.geometry_normal: 3,
    Channels.shading_normal: 3,
    Channels.uv: 2,
    Channels.barycentric_coordinates: 2,
    Channels.diffuse_reflectance: 3,
    Channels.specular_reflectance: 3,
    Channels.roughness: 1,
    Channels.vertex_color: 3,
    Channels.shape_id: 1,
    Channels.triangle_id: 1,
    Channels.material_id: 1,
}


def channel_dims(channel: Channels, max_generic_texture_dimension: int = 16) -> int:
    if channel == Channels.generic_texture:
        return max_generic_texture_dimension
    return _FIXED_DIMS[channel]


class ChannelInfo:
    """Static per-render channel layout (src/channels.cpp:6-40)."""

    def __init__(
        self,
        channels: Sequence[Channels],
        max_generic_texture_dimension: int = 16,
    ):
        self.channels: Tuple[Channels, ...] = tuple(channels)
        self.max_generic_texture_dimension = max_generic_texture_dimension
        self.num_channels = len(self.channels)
        offsets = []
        off = 0
        radiance_dimension = -1
        for c in self.channels:
            if c == Channels.radiance:
                if radiance_dimension != -1:
                    raise ValueError("Duplicated radiance channel")
                radiance_dimension = off
            offsets.append(off)
            off += channel_dims(c, max_generic_texture_dimension)
        self.offsets = tuple(offsets)
        self.num_total_dimensions = off
        self.radiance_dimension = radiance_dimension

    def offset_of(self, channel: Channels) -> int:
        return self.offsets[self.channels.index(channel)]
