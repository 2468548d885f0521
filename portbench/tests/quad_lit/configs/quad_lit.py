"""quad_lit's scenes (run.load_config): a diffuse quad under a quad
light, with the leaves quad.diffuse and light.intensity.  The reference's
scene is the quad, the light and the camera, and its render is its own
loop over reference/plain.py's paths.  No edge terms."""

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import plain

LEAVES = {
    "quad.diffuse": lambda s: s.materials[0].diffuse_reflectance.texels,
    "light.intensity": lambda s: s.area_lights[0].intensity,
}
REFERENCE_LEAVES = {
    "quad.diffuse": lambda s: s.quad.diffuse,
    "light.intensity": lambda s: s.light.emission,
}
EDGES = None


def _mesh(part, device):
    return (torch.as_tensor(part["vertices"], dtype=torch.float32,
                            device=device),
            torch.as_tensor(part["indices"], dtype=torch.int64,
                            device=device))


def build_scene(api, cfg, resolution, device):
    cam = cfg["camera"]
    camera = api.make_camera(position=cam["position"],
                             look_at=cam["look_at"], up=cam["up"],
                             fov=cam["fov"], resolution=tuple(resolution),
                             device=device)
    (qv, qf), (lv, lf) = _mesh(cfg["quad"], device), _mesh(cfg["light"],
                                                           device)
    return api.scene_from_objects(camera, [
        api.Object(vertices=qv, indices=qf, material=api.make_material(
            diffuse_reflectance=cfg["quad"]["diffuse"], device=device)),
        api.Object(vertices=lv, indices=lf, material=api.make_material(
            diffuse_reflectance=[0.0, 0.0, 0.0], device=device),
            light_intensity=torch.as_tensor(cfg["light"]["intensity"],
                                            dtype=torch.float32,
                                            device=device))])


def build_reference(cfg, resolution, device):
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    cam = cfg["camera"]
    (qv, qf), (lv, lf) = _mesh(cfg["quad"], device), _mesh(cfg["light"],
                                                           device)
    return SimpleNamespace(
        camera=plain.Camera(t(cam["position"]), t(cam["look_at"]),
                            t(cam["up"]), float(cam["fov"]),
                            int(resolution[0]), int(resolution[1])),
        quad=plain.Mesh(qv, qf, diffuse=t(cfg["quad"]["diffuse"])),
        light=plain.Mesh(lv, lf, diffuse=t([0.0, 0.0, 0.0]),
                         emission=t(cfg["light"]["intensity"])))


def perturbed(traffic, seed):
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 7])
    p = traffic["perturb"]
    return {"quad.diffuse": ("set", rng.uniform(*p["diffuse"], 3)),
            "light.intensity": ("scale", 1 + rng.uniform(-1, 1, 3)
                                * p["intensity_scale"])}


def posed(scene, leaves):
    return scene


def posed_reference(scene, leaves):
    return scene


def render_reference(scene, num_samples, seed, bounces):
    """The mean of num_samples of plain's paths a pixel, all lanes at
    once."""
    ps = plain.Scene(scene.camera, [scene.quad, scene.light])
    cam = ps.camera
    npix = cam.height * cam.width
    lane = torch.arange(npix * num_samples, device=cam.position.device)
    pixel, sample = lane % npix, lane // npix
    radiance = plain.trace(ps, plain.flatten(ps), plain.light_tables(ps),
                           seed, pixel, sample, bounces)
    img = torch.zeros((npix, 3), device=cam.position.device)
    return (img.index_add(0, pixel, radiance) / num_samples).reshape(
        cam.height, cam.width, 3)


def move_reference_camera(scene, position):
    scene.camera.position.copy_(torch.as_tensor(position))
