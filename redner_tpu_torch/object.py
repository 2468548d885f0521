"""Object API: mesh + material + optional emission in one bundle (port of
redner_tpu/object.py; reference pyredner/object.py)."""

from __future__ import annotations

from redner_tpu_torch.geometry import make_shape
from redner_tpu_torch.light import make_area_light
from redner_tpu_torch.material import Material


class Object:
    """A renderable object (pyredner/object.py:5-76).  Tensors keep the
    device they were made on."""

    def __init__(
        self,
        vertices,
        indices,
        material: Material,
        uvs=None,
        normals=None,
        uv_indices=None,
        normal_indices=None,
        colors=None,
        light_intensity=None,
        light_two_sided: bool = False,
        directly_visible: bool = True,
        weld_ids=None,
    ):
        self.vertices = vertices
        self.indices = indices
        self.material = material
        self.uvs = uvs
        self.normals = normals
        self.uv_indices = uv_indices
        self.normal_indices = normal_indices
        self.colors = colors
        self.light_intensity = light_intensity
        self.light_two_sided = light_two_sided
        self.directly_visible = directly_visible
        self.weld_ids = weld_ids


def scene_from_objects(camera, objects, envmap=None):
    """Build a Scene from Objects with material dedup
    (reference pyredner/scene.py:21-68)."""
    from redner_tpu_torch.scene import make_scene

    dev = camera.device
    materials = []
    mat_ids = {}
    shapes = []
    lights = []
    for obj in objects:
        key = id(obj.material)
        if key not in mat_ids:
            mat_ids[key] = len(materials)
            materials.append(obj.material)
        light_id = -1
        if obj.light_intensity is not None:
            light_id = len(lights)
            lights.append(
                make_area_light(
                    len(shapes),
                    obj.light_intensity,
                    two_sided=obj.light_two_sided,
                    directly_visible=obj.directly_visible,
                    device=dev,
                )
            )
        shapes.append(
            make_shape(
                vertices=obj.vertices,
                indices=obj.indices,
                uvs=obj.uvs,
                normals=obj.normals,
                uv_indices=obj.uv_indices,
                normal_indices=obj.normal_indices,
                colors=obj.colors,
                material_id=mat_ids[key],
                light_id=light_id,
                weld_ids=obj.weld_ids,
                device=dev,
            )
        )
    return make_scene(camera, shapes, materials, area_lights=lights,
                      envmap=envmap)
