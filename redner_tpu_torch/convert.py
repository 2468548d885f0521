"""Build a port Scene from plain arrays, so that a scene described once
(for example by the JAX package) renders identically in this one.

`scene_from_arrays(d, device)` takes a nested dict of numpy arrays and
Python scalars:

    {"camera": {"position", "look_at", "up": (3,) or "cam_to_world": (4, 4),
                "fov": degrees or "intrinsic_mat": (3, 3),
                "resolution": (h, w), optional "distortion_params": (8,),
                "camera_type": a CameraType name, "viewport": (top, left,
                bottom, right), "clip_near": float},
     "shapes": [{"vertices": (V, 3), "indices": (F, 3),
                 optional "uvs", "normals", "uv_indices", "normal_indices",
                 "colors", "weld_ids", and "material_id", "light_id": int}],
     "materials": [{"diffuse_reflectance": (3,) or (H, W, 3),
                    "specular_reflectance": (3,) or (H, W, 3),
                    "roughness": (1,) or (H, W, 1),
                    optional "normal_map": (H, W, 3),
                    optional "generic_texture": (C,) or (H, W, C),
                    optional "<stack>_uv_scale": (2,) for any of the five,
                    "compute_specular_lighting", "two_sided",
                    "use_vertex_color": bool}],
     "area_lights": [{"shape_id": int, "intensity": (3,),
                      optional "two_sided", "directly_visible": bool}],
     optional "envmap": {"values": (H, W, 3), "env_to_world": (4, 4),
                         optional "world_to_env": (4, 4) (default: the
                         inverse), "uv_scale": (2,),
                         "directly_visible": bool}}
"""

from __future__ import annotations

import dataclasses

import torch

from redner_tpu_torch.camera import CameraType, make_camera
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.envmap import make_environment_map
from redner_tpu_torch.geometry import make_shape
from redner_tpu_torch.light import make_area_light
from redner_tpu_torch.material import Material
from redner_tpu_torch.scene import Scene, make_scene
from redner_tpu_torch.texture import make_texture

_SHAPE_ARRAYS = ("uvs", "normals", "uv_indices", "normal_indices", "colors",
                 "weld_ids")
_CAMERA_KEYS = ("position", "look_at", "up", "fov", "cam_to_world",
                "intrinsic_mat", "distortion_params", "viewport")


def scene_from_arrays(d: dict, device=None, dtype=torch.float32) -> Scene:
    dev = resolve_device(device)
    c = d["camera"]
    camera = make_camera(
        **{k: c.get(k) for k in _CAMERA_KEYS},
        camera_type=CameraType[c.get("camera_type", "perspective")],
        clip_near=float(c.get("clip_near", 1e-4)),
        resolution=tuple(c["resolution"]), dtype=dtype, device=dev,
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

    def tex(m, key):
        if m.get(key) is None:
            return None
        return make_texture(m[key], uv_scale=m.get(key + "_uv_scale"),
                            dtype=dtype, device=dev)

    materials = [
        Material(
            diffuse_reflectance=tex(m, "diffuse_reflectance"),
            specular_reflectance=tex(m, "specular_reflectance"),
            roughness=tex(m, "roughness"),
            generic_texture=tex(m, "generic_texture"),
            normal_map=tex(m, "normal_map"),
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
    envmap = None
    e = d.get("envmap")
    if e is not None:
        envmap = make_environment_map(
            make_texture(e["values"], uv_scale=e.get("uv_scale"), dtype=dtype,
                         device=dev),
            env_to_world=e.get("env_to_world"),
            directly_visible=bool(e.get("directly_visible", True)),
            dtype=dtype)
        if e.get("world_to_env") is not None:
            envmap = dataclasses.replace(envmap, world_to_env=torch.as_tensor(
                e["world_to_env"], dtype=dtype, device=dev))
    return make_scene(camera, shapes, materials, area_lights=lights,
                      envmap=envmap)
