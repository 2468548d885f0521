"""Object of the torch front end: mesh + material + optional emission
(port of redner_torch/object.py; reference pyredner/object.py)."""

from __future__ import annotations

from redner_tpu_torch.frontend._tensor import _as_int_tensor, _as_tensor
from redner_tpu_torch.frontend.material import Material


class Object:
    """weld_ids: the (V,) load-time weld map of a loaded mesh (load_obj,
    load_mitsuba), carried to the Shape that Scene(objects=...) makes."""

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
        self.vertices = _as_tensor(vertices)
        self.indices = _as_int_tensor(indices)
        self.material = material
        self.uvs = _as_tensor(uvs)
        self.normals = _as_tensor(normals)
        self.uv_indices = _as_int_tensor(uv_indices)
        self.normal_indices = _as_int_tensor(normal_indices)
        self.colors = _as_tensor(colors)
        self.light_intensity = _as_tensor(light_intensity)
        self.light_two_sided = bool(light_two_sided)
        self.directly_visible = bool(directly_visible)
        self.weld_ids = _as_int_tensor(weld_ids)
