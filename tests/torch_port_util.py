"""Helpers that carry redner_tpu scenes and rays across to redner_tpu_torch
for the port's comparison tests (the port itself never imports JAX)."""

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


@pytest.fixture
def one_thread():
    """One intra-op thread: the accumulating index backward then sums in a
    fixed order, so two runs of one gradient agree bit for bit (with two
    threads they need not)."""
    keep = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(keep)


@pytest.fixture
def cpu_default_device():
    """set_device("cpu") for one test, then the default (the CUDA card)
    again, so no test leaves the process-wide choice behind."""
    rtt.set_device("cpu")
    yield
    rtt.set_device(None)


def _arr(x):
    return None if x is None else np.array(x)


_STACKS = ("diffuse_reflectance", "specular_reflectance", "roughness",
           "generic_texture", "normal_map")


def scene_arrays(scene) -> dict:
    """The nested dict of numpy arrays that redner_tpu_torch.scene_from_arrays
    takes, filled from a redner_tpu Scene (any camera, constant or
    image-texture materials, generic textures and normal maps, weld maps,
    area lights, an envmap)."""
    cam = scene.camera
    camera = {
        "intrinsic_mat": _arr(cam.intrinsic_mat),
        "distortion_params": (_arr(cam.distortion_params)
                              if cam.has_distortion else None),
        "camera_type": cam.camera_type.name, "resolution": cam.resolution,
        "viewport": cam.viewport, "clip_near": cam.clip_near,
    }
    if cam.use_look_at:
        camera.update(position=_arr(cam.position), look_at=_arr(cam.look_at),
                      up=_arr(cam.up))
    else:
        camera["cam_to_world"] = _arr(cam.cam_to_world)
    shapes = [
        {
            "vertices": _arr(s.vertices), "indices": _arr(s.indices),
            "uvs": _arr(s.uvs), "normals": _arr(s.normals),
            "uv_indices": _arr(s.uv_indices),
            "normal_indices": _arr(s.normal_indices),
            "colors": _arr(s.colors), "weld_ids": _arr(s.weld_ids),
            "material_id": s.material_id, "light_id": s.light_id,
        }
        for s in scene.shapes
    ]
    materials = []
    for m in scene.materials:
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
        "values": _arr(env.values.texels),
        "uv_scale": _arr(env.values.uv_scale),
        "env_to_world": _arr(env.env_to_world),
        "world_to_env": _arr(env.world_to_env),
        "directly_visible": env.directly_visible,
    }
    return {
        "envmap": envmap,
        "camera": camera,
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


def aov_scene(res=(16, 16), close=False):
    """A redner_tpu scene that feeds every AOV channel: a back quad with
    uvs, vertex colours, an 8x8 diffuse texture, a normal map and a
    five-channel 8x8 generic texture; a front triangle with shading normals
    and a constant three-channel generic texture; a quad area light; and a
    gradient envmap.  close=True moves the camera in until the back quad
    fills the view (no camera ray misses)."""
    import redner_tpu as rt

    rng = np.random.default_rng(3)
    cam = rt.make_camera(
        position=[0.0, 0.1, -1.6] if close else [0.0, 0.3, -4.0],
        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0], fov=45.0,
        resolution=res)
    back = rt.make_shape(
        vertices=[[-1.3, -1.2, 0.3], [1.2, -1.3, 0.2], [-1.2, 1.3, 0.2],
                  [1.3, 1.2, 0.1]],
        indices=[[0, 2, 1], [1, 2, 3]],
        uvs=[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
        colors=rng.uniform(0.1, 0.9, (4, 3)).astype(np.float32),
        material_id=0)
    tri = rt.make_shape(
        vertices=[[-0.6, -0.5, -0.5], [0.7, -0.4, -0.6], [0.0, 0.7, -0.4]],
        indices=[[0, 1, 2]],
        normals=[[0.1, 0.0, -1.0], [0.0, 0.1, -1.0], [-0.1, 0.0, -1.0]],
        material_id=1)
    light = rt.generate_quad_light(position=[0.0, 2.5, -1.5],
                                   look_at=[0.0, 0.0, 0.0], size=[1.0, 1.0],
                                   intensity=[8.0, 8.0, 8.0])
    lshape = rt.make_shape(vertices=light.vertices, indices=light.indices,
                           material_id=2, light_id=0)
    nmap = np.concatenate([0.5 + 0.15 * rng.uniform(-1, 1, (8, 8, 2)),
                           np.ones((8, 8, 1))], axis=-1).astype(np.float32)
    textured = rt.make_material(
        diffuse_reflectance=rng.uniform(0.2, 0.8, (8, 8, 3)).astype(
            np.float32),
        specular_reflectance=np.asarray([0.15, 0.15, 0.15], np.float32),
        roughness=np.asarray([0.4], np.float32),
        generic_texture=rt.make_texture(
            rng.uniform(0, 1, (8, 8, 5)).astype(np.float32)),
        normal_map=rt.make_texture(nmap))
    plain = rt.make_material(
        diffuse_reflectance=np.asarray([0.6, 0.3, 0.2], np.float32),
        specular_reflectance=np.asarray([0.3, 0.3, 0.3], np.float32),
        roughness=np.asarray([0.2], np.float32),
        generic_texture=rt.make_texture(
            np.asarray([0.25, 0.5, 0.75], np.float32)))
    black = rt.make_material(diffuse_reflectance=np.zeros(3, np.float32))
    h, w = 8, 16
    y = np.linspace(0.2, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.3, 0.9, w, dtype=np.float32)[None, :, None]
    values = np.concatenate([y * np.ones((1, w, 1), np.float32),
                             x * np.ones((h, 1, 1), np.float32),
                             0.5 * np.ones((h, w, 1), np.float32)], axis=-1)
    env = rt.make_environment_map(values)
    return rt.make_scene(cam, [back, tri, lshape], [textured, plain, black],
                         area_lights=[rt.make_area_light(2, [8.0] * 3)],
                         envmap=env)
