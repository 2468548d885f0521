"""Material of the torch front end (port of redner_torch/material.py;
reference pyredner/material.py)."""

from __future__ import annotations

from typing import Optional

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend.texture import Texture


def _as_texture(x, default=None) -> Optional[Texture]:
    if x is None:
        return None if default is None else Texture(default)
    return x if isinstance(x, Texture) else Texture(x)


class Material:
    """Diffuse + Blinn-Phong specular material; every texture map is a
    differentiable leaf (reference pyredner/material.py:5-68)."""

    def __init__(
        self,
        diffuse_reflectance=None,
        specular_reflectance=None,
        roughness=None,
        generic_texture=None,
        normal_map=None,
        two_sided: bool = False,
        use_vertex_color: bool = False,
    ):
        self.compute_specular_lighting = specular_reflectance is not None
        self.diffuse_reflectance = _as_texture(diffuse_reflectance,
                                               [0.0, 0.0, 0.0])
        self.specular_reflectance = _as_texture(specular_reflectance,
                                                [0.0, 0.0, 0.0])
        self.roughness = _as_texture(roughness, [1.0])
        self.generic_texture = _as_texture(generic_texture)
        self.normal_map = _as_texture(normal_map)
        self.two_sided = bool(two_sided)
        self.use_vertex_color = bool(use_vertex_color)

    def _build(self, dev) -> rtt.Material:
        def tex(t):
            return None if t is None else t._build(dev)

        return rtt.Material(
            diffuse_reflectance=tex(self.diffuse_reflectance),
            specular_reflectance=tex(self.specular_reflectance),
            roughness=tex(self.roughness),
            generic_texture=tex(self.generic_texture),
            normal_map=tex(self.normal_map),
            compute_specular_lighting=self.compute_specular_lighting,
            two_sided=self.two_sided,
            use_vertex_color=self.use_vertex_color,
        )
