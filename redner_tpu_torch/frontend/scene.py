"""Scene of the torch front end (port of redner_torch/scene.py; reference
pyredner/scene.py).

Takes either the classic pyredner constructor (camera, shapes, materials,
area_lights, envmap) or (camera, objects=[Object, ...]), which dedups
materials by identity and makes an AreaLight for each emissive Object.
`_build` makes the port's Scene from the held tensors with differentiable
ops only; every render calls it.
"""

from __future__ import annotations

from typing import List, Optional

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend.area_light import AreaLight
from redner_tpu_torch.frontend.camera import Camera
from redner_tpu_torch.frontend.envmap import EnvironmentMap
from redner_tpu_torch.frontend.material import Material
from redner_tpu_torch.frontend.object import Object
from redner_tpu_torch.frontend.shape import Shape


class Scene:
    def __init__(
        self,
        camera: Camera,
        shapes: Optional[List[Shape]] = None,
        materials: Optional[List[Material]] = None,
        area_lights: Optional[List[AreaLight]] = None,
        objects: Optional[List[Object]] = None,
        envmap: Optional[EnvironmentMap] = None,
    ):
        self.camera = camera
        self.envmap = envmap
        if objects is not None:
            if not (shapes is None and materials is None
                    and area_lights is None):
                raise ValueError("Scene takes objects or (shapes, materials, "
                                 "area_lights), not both")
            shapes, materials, area_lights = [], [], []
            mat_ids = {}
            for obj in objects:
                key = id(obj.material)
                if key not in mat_ids:
                    mat_ids[key] = len(materials)
                    materials.append(obj.material)
                shape = Shape(
                    vertices=obj.vertices, indices=obj.indices,
                    material_id=mat_ids[key], uvs=obj.uvs,
                    normals=obj.normals, uv_indices=obj.uv_indices,
                    normal_indices=obj.normal_indices, colors=obj.colors,
                    weld_ids=obj.weld_ids,
                )
                if obj.light_intensity is not None:
                    shape.light_id = len(area_lights)
                    area_lights.append(AreaLight(
                        shape_id=len(shapes), intensity=obj.light_intensity,
                        two_sided=obj.light_two_sided,
                        directly_visible=obj.directly_visible))
                shapes.append(shape)
        self.shapes = list(shapes or [])
        self.materials = list(materials or [])
        self.area_lights = list(area_lights or [])

    def _build(self) -> rtt.Scene:
        """The port's Scene on the device of the first shape's vertices."""
        if not self.shapes:
            raise ValueError("scene needs at least one shape")
        dev = self.shapes[0].vertices.device
        # pyredner shapes carry no light id: emission is defined by
        # AreaLight.shape_id alone (pyredner/scene.py), so wire the port's
        # per-shape light_id here.
        light_ids = [s.light_id for s in self.shapes]
        for i, light in enumerate(self.area_lights):
            if 0 <= light.shape_id < len(light_ids):
                light_ids[light.shape_id] = i
        return rtt.make_scene(
            self.camera._build(dev),
            [s._build(dev, lid) for s, lid in zip(self.shapes, light_ids)],
            [m._build(dev) for m in self.materials],
            area_lights=[light._build(dev) for light in self.area_lights],
            envmap=None if self.envmap is None else self.envmap._build(dev),
        )
