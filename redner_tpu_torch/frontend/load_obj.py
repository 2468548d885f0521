"""OBJ loading with front-end outputs (port of redner_torch/load_obj.py;
reference pyredner/load_obj.py).

Loads through the port's loader (rtt.load_obj), which gives every mesh its
load-time weld map; the front end keeps it (Object.weld_ids, and
TriangleMesh.weld_ids in the tuple form), where redner_torch drops it."""

from __future__ import annotations

from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.frontend._convert import (material_from_port,
                                                object_from_port)
from redner_tpu_torch.frontend._tensor import _as_tensor
from redner_tpu_torch.io.obj import load_obj as _load_obj


def load_obj(filename: str, obj_group: bool = True,
             flip_tex_coords: bool = True, use_common_indices: bool = False,
             return_objects: bool = False):
    """Load an OBJ onto the default device -> (material_map, mesh_list,
    light_map) of front-end Materials, the port's TriangleMeshes
    (redner_tpu_torch.io.obj) and intensity tensors, or a list of
    front-end Objects with return_objects=True."""
    out = _load_obj(filename, obj_group=obj_group,
                    flip_tex_coords=flip_tex_coords,
                    use_common_indices=use_common_indices,
                    return_objects=return_objects,
                    device=resolve_device(None))
    if return_objects:
        return [object_from_port(o) for o in out]
    material_map, mesh_list, light_map = out
    return ({k: material_from_port(v) for k, v in material_map.items()},
            mesh_list, {k: _as_tensor(v) for k, v in light_map.items()})
