"""Helpers that carry redner_tpu scenes and rays across to redner_tpu_torch
for the port's comparison tests (the port itself never imports JAX)."""

import math

import numpy as np
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.core.types import Ray as TRay


def _arr(x):
    return None if x is None else np.array(x)


def scene_arrays(scene) -> dict:
    """The nested dict of numpy arrays that redner_tpu_torch.scene_from_arrays
    takes, filled from a redner_tpu Scene (perspective look-at camera,
    constant materials, area lights)."""
    cam = scene.camera
    assert cam.use_look_at and not cam.has_distortion
    fx = float(np.asarray(cam.intrinsic_mat)[0, 0])
    shapes = [
        {
            "vertices": _arr(s.vertices), "indices": _arr(s.indices),
            "uvs": _arr(s.uvs), "normals": _arr(s.normals),
            "uv_indices": _arr(s.uv_indices),
            "normal_indices": _arr(s.normal_indices),
            "colors": _arr(s.colors),
            "material_id": s.material_id, "light_id": s.light_id,
        }
        for s in scene.shapes
    ]
    materials = []
    for m in scene.materials:
        assert m.normal_map is None and m.generic_texture is None
        materials.append({
            "diffuse_reflectance": _arr(m.diffuse_reflectance.texels),
            "specular_reflectance": _arr(m.specular_reflectance.texels),
            "roughness": _arr(m.roughness.texels),
            "compute_specular_lighting": m.compute_specular_lighting,
            "two_sided": m.two_sided,
            "use_vertex_color": m.use_vertex_color,
        })
    lights = [
        {"shape_id": l.shape_id, "intensity": _arr(l.intensity),
         "two_sided": l.two_sided, "directly_visible": l.directly_visible}
        for l in scene.area_lights
    ]
    return {
        "camera": {
            "position": _arr(cam.position), "look_at": _arr(cam.look_at),
            "up": _arr(cam.up),
            "fov": math.degrees(2.0 * math.atan(1.0 / fx)),
            "resolution": cam.resolution,
        },
        "shapes": shapes,
        "materials": materials,
        "area_lights": lights,
    }


def port_scene(scene, device="cpu"):
    return rtt.scene_from_arrays(scene_arrays(scene), device=device)


def port_ray(ray, device="cpu"):
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    n = np.asarray(ray.org).shape[:-1]
    return TRay(org=t(ray.org), dir=t(ray.dir),
                tmin=t(np.broadcast_to(np.asarray(ray.tmin), n)),
                tmax=t(np.broadcast_to(np.asarray(ray.tmax), n)))
