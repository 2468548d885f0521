"""OBJ/MTL export of front-end shapes and materials (port of
redner_torch/save_obj.py; reference pyredner/save_obj.py)."""

from __future__ import annotations

from redner_tpu_torch.io.obj import save_mtl as _save_mtl
from redner_tpu_torch.io.obj import save_obj as _save_obj


def save_obj(shape, filename: str, flip_tex_coords: bool = True):
    """Write a front-end Shape or Object to OBJ."""
    _save_obj(shape, filename, flip_tex_coords=flip_tex_coords)


def save_mtl(material, filename: str, name: str = "material_0"):
    """Write a front-end Material's constant values to MTL."""
    _save_mtl(material, filename, name=name)
