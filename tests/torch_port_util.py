"""Helpers that carry redner_tpu scenes and rays across to redner_tpu_torch
for the port's comparison tests (the port itself never imports JAX)."""

import math

import numpy as np
import pytest
import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.core.types import Ray as TRay


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The lane runs several test processes on few cores; eager PyTorch on
    small tensors with every core per process mostly waits on its own
    threads.  A test module takes this autouse fixture by importing it."""
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)


def _arr(x):
    return None if x is None else np.array(x)


_STACKS = ("diffuse_reflectance", "specular_reflectance", "roughness",
           "normal_map")


def scene_arrays(scene) -> dict:
    """The nested dict of numpy arrays that redner_tpu_torch.scene_from_arrays
    takes, filled from a redner_tpu Scene (perspective look-at camera,
    constant or image-texture materials and normal maps, area lights, an
    envmap)."""
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
        assert m.generic_texture is None
        d = {"compute_specular_lighting": m.compute_specular_lighting,
             "two_sided": m.two_sided,
             "use_vertex_color": m.use_vertex_color}
        for key in _STACKS:
            tex = getattr(m, key)
            if tex is not None:
                d[key] = _arr(tex.texels)
                d[key + "_uv_scale"] = _arr(tex.uv_scale)
        materials.append(d)
    lights = [
        {"shape_id": l.shape_id, "intensity": _arr(l.intensity),
         "two_sided": l.two_sided, "directly_visible": l.directly_visible}
        for l in scene.area_lights
    ]
    env = scene.envmap
    envmap = None if env is None else {
        "values": _arr(env.values.texels), "uv_scale": _arr(env.values.uv_scale),
        "env_to_world": _arr(env.env_to_world),
        "world_to_env": _arr(env.world_to_env),
        "directly_visible": env.directly_visible,
    }
    return {
        "envmap": envmap,
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


def shadow_grads_jax(scene, options, seed, weight):
    """jax.grad of sum(redner_tpu.render(scene) * weight) w.r.t. (diffuse
    reflectance, light intensity, per-shape vertices, camera position) of a
    one-material, one-light scene."""
    import jax
    import jax.numpy as jnp

    import redner_tpu as rt

    def loss(params):
        diffuse, intensity, verts, cam_pos = params
        mat = scene.materials[0]
        mat = mat.replace(diffuse_reflectance=mat.diffuse_reflectance.replace(
            texels=diffuse))
        sc = scene.replace(
            materials=(mat,),
            area_lights=(scene.area_lights[0].replace(intensity=intensity),),
            shapes=tuple(s.replace(vertices=v)
                         for s, v in zip(scene.shapes, verts)),
            camera=scene.camera.replace(position=cam_pos))
        return jnp.sum(rt.render(sc, options, seed=seed) * weight)

    params = (scene.materials[0].diffuse_reflectance.texels,
              scene.area_lights[0].intensity,
              tuple(s.vertices for s in scene.shapes), scene.camera.position)
    g_diffuse, g_int, g_verts, g_pos = jax.grad(loss)(params)
    return [np.asarray(g_diffuse), np.asarray(g_int),
            *(np.asarray(g) for g in g_verts), np.asarray(g_pos)]


def shadow_grads_port(tscene, options, seed, weight, engine=None):
    """The same gradients through redner_tpu_torch.render; also returns the
    image."""
    leaves = ([tscene.materials[0].diffuse_reflectance.texels,
               tscene.area_lights[0].intensity]
              + [s.vertices for s in tscene.shapes] + [tscene.camera.position])
    for x in leaves:
        x.requires_grad_(True)
    img = rtt.render(tscene, options, seed=seed, engine=engine)
    torch.sum(img * torch.as_tensor(weight, device=img.device)).backward()
    grads = [x.grad.detach().cpu().numpy() for x in leaves]
    for x in leaves:
        x.grad = None
        x.requires_grad_(False)
    return img.detach(), grads


def port_ray(ray, device="cpu"):
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    n = np.asarray(ray.org).shape[:-1]
    return TRay(org=t(ray.org), dir=t(ray.dir),
                tmin=t(np.broadcast_to(np.asarray(ray.tmin), n)),
                tmax=t(np.broadcast_to(np.asarray(ray.tmax), n)))
