"""Build a port Scene from plain arrays, so that a scene described once
(for example by the JAX package) renders identically in this one.

`scene_from_arrays(d, device)` takes a nested dict of numpy arrays and
Python scalars:

    {"camera": {"position", "look_at", "up": (3,), "fov": degrees,
                "resolution": (h, w)},
     "shapes": [{"vertices": (V, 3), "indices": (F, 3),
                 optional "uvs", "normals", "uv_indices", "normal_indices",
                 "colors", and "material_id", "light_id": int}],
     "materials": [{"diffuse_reflectance": (3,), "specular_reflectance": (3,),
                    "roughness": (1,), "compute_specular_lighting",
                    "two_sided", "use_vertex_color": bool}],
     "area_lights": [{"shape_id": int, "intensity": (3,),
                      optional "two_sided", "directly_visible": bool}]}
"""

from __future__ import annotations

import torch

from redner_tpu_torch.camera import make_camera
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.geometry import make_shape
from redner_tpu_torch.light import make_area_light
from redner_tpu_torch.material import Material
from redner_tpu_torch.scene import Scene, make_scene
from redner_tpu_torch.texture import make_texture

_SHAPE_ARRAYS = ("uvs", "normals", "uv_indices", "normal_indices", "colors")


def scene_from_arrays(d: dict, device=None, dtype=torch.float32) -> Scene:
    dev = resolve_device(device)
    c = d["camera"]
    camera = make_camera(
        position=c["position"], look_at=c["look_at"], up=c["up"],
        fov=c["fov"], resolution=tuple(c["resolution"]), dtype=dtype,
        device=dev,
    )
    shapes = [
        make_shape(
            vertices=s["vertices"], indices=s["indices"],
            **{k: s.get(k) for k in _SHAPE_ARRAYS},
            material_id=int(s.get("material_id", 0)),
            light_id=int(s.get("light_id", -1)),
            dtype=dtype, device=dev,
        )
        for s in d["shapes"]
    ]
    tex = lambda x: make_texture(x, dtype=dtype, device=dev)
    materials = [
        Material(
            diffuse_reflectance=tex(m["diffuse_reflectance"]),
            specular_reflectance=tex(m["specular_reflectance"]),
            roughness=tex(m["roughness"]),
            compute_specular_lighting=bool(m["compute_specular_lighting"]),
            two_sided=bool(m.get("two_sided", False)),
            use_vertex_color=bool(m.get("use_vertex_color", False)),
        )
        for m in d["materials"]
    ]
    lights = [
        make_area_light(
            int(l["shape_id"]), l["intensity"],
            two_sided=bool(l.get("two_sided", False)),
            directly_visible=bool(l.get("directly_visible", True)),
            dtype=dtype, device=dev,
        )
        for l in d.get("area_lights", ())
    ]
    return make_scene(camera, shapes, materials, area_lights=lights)
