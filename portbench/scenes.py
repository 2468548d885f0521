"""The scene of a sphere on a floor under a quad light, built from a
configuration's JSON file: what configs/pose_sphere15k.py hands the
harness.  The benchmark makes every input array itself (the UV sphere of
pyredner's `generate_sphere`, the floor and the quad light of
`generate_quad_light`) and hands the same arrays to both sides: to the
port through its user API (`build_scene`) and to the plain reference
(`build_plain`).  Nothing built by one side is handed to the other.

Leaves are named `<part>.<field>`.  "sphere.translation" is a leaf of its
own, a (3,) offset added to the sphere's vertices before each render (the
pose parameters of redner's pose-estimation tutorial): it lives in
neither scene (None in LEAVES and PLAIN_LEAVES), and `posed` applies it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench import loops
from portbench.reference import plain

# Where each leaf lives in a port scene (redner_tpu_torch.Scene).
LEAVES = {
    "sphere.translation": None,
    "sphere.diffuse": lambda s: s.materials[0].diffuse_reflectance.texels,
    "sphere.specular": lambda s: s.materials[0].specular_reflectance.texels,
    "sphere.roughness": lambda s: s.materials[0].roughness.texels,
    "camera.position": lambda s: s.camera.position,
    "camera.look_at": lambda s: s.camera.look_at,
    "light.intensity": lambda s: s.area_lights[0].intensity,
}

# ... and in a reference scene (plain.Scene: sphere, floor, light).
PLAIN_LEAVES = {
    "sphere.translation": None,
    "sphere.diffuse": lambda s: s.meshes[0].diffuse,
    "sphere.specular": lambda s: s.meshes[0].specular,
    "sphere.roughness": lambda s: s.meshes[0].roughness,
    "camera.position": lambda s: s.camera.position,
    "camera.look_at": lambda s: s.camera.look_at,
    "light.intensity": lambda s: s.meshes[2].emission,
}


def sphere_arrays(theta_steps, phi_steps):
    """A UV sphere of radius 1 at the origin as pyredner.generate_sphere
    makes it: float32 vertices, int64 faces, uvs and normals."""
    d_theta = math.pi / (theta_steps - 1)
    d_phi = 2 * math.pi / (phi_steps - 1)
    th = np.arange(theta_steps)[:, None] * d_theta
    ph = np.arange(phi_steps)[None, :] * d_phi
    verts = np.stack(np.broadcast_arrays(np.sin(th) * np.cos(ph), np.cos(th),
                                         np.sin(th) * np.sin(ph)), -1)
    verts = verts.reshape(-1, 3)
    uvs = np.stack(np.broadcast_arrays(ph / (2 * math.pi), th / math.pi),
                   -1).reshape(-1, 2)
    faces = []
    for t in range(1, theta_steps):
        for p in range(phi_steps - 1):
            i0, i1 = phi_steps * t + p, phi_steps * t + p + 1
            i2, i3 = phi_steps * (t - 1) + p, phi_steps * (t - 1) + p + 1
            if t < theta_steps - 1:
                faces.append([i0, i2, i1])
            if t > 1:
                faces.append([i1, i2, i3])
    return (verts.astype(np.float32), np.asarray(faces, np.int64),
            uvs.astype(np.float32), verts.astype(np.float32))


def quad_light_arrays(position, look_at, size):
    """The four corners and two faces of a quad of `size` at `position`
    facing `look_at`, wound so that its normal points at it (pyredner's
    generate_quad_light)."""
    pos, look = np.asarray(position, np.float64), np.asarray(look_at,
                                                             np.float64)
    z = (look - pos) / np.linalg.norm(look - pos)
    up = np.array([0.0, 1.0, 0.0]) if abs(z[1]) <= 0.999 else np.array(
        [1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    hx, hy = 0.5 * size[0], 0.5 * size[1]
    verts = np.stack([pos - hx * x - hy * y, pos + hx * x - hy * y,
                      pos - hx * x + hy * y, pos + hx * x + hy * y])
    return verts.astype(np.float32), np.array([[0, 1, 2], [1, 3, 2]],
                                              np.int64)


def _arrays(cfg):
    sph, flo, lig = cfg["sphere"], cfg["floor"], cfg["light"]
    return (sphere_arrays(sph["theta_steps"], sph["phi_steps"]),
            (np.asarray(flo["vertices"], np.float32),
             np.asarray(flo["indices"], np.int64)),
            quad_light_arrays(lig["position"], lig["look_at"], lig["size"]))


def build_scene(api, cfg, resolution, device):
    """The configuration's scene through the port's user API: the sphere
    with its constant glossy material, the floor and the quad area light.
    resolution: (height, width)."""
    (sv, sf, suv, sn), (fv, ff), (lv, lf) = _arrays(cfg)
    cam = cfg["camera"]
    camera = api.make_camera(position=cam["position"],
                             look_at=cam["look_at"], up=cam["up"],
                             fov=cam["fov"], resolution=tuple(resolution),
                             device=device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    mat = cfg["sphere"]["material"]
    objs = [
        api.Object(vertices=t(sv), indices=t(sf), uvs=t(suv), normals=t(sn),
                   material=api.make_material(
                       diffuse_reflectance=mat["diffuse"],
                       specular_reflectance=mat["specular"],
                       roughness=mat["roughness"], device=device)),
        api.Object(vertices=t(fv), indices=t(ff),
                   material=api.make_material(
                       diffuse_reflectance=cfg["floor"]["diffuse"],
                       device=device)),
        api.Object(vertices=t(lv), indices=t(lf),
                   material=api.make_material(
                       diffuse_reflectance=[0.0, 0.0, 0.0], device=device),
                   light_intensity=torch.as_tensor(
                       cfg["light"]["intensity"], dtype=torch.float32,
                       device=device)),
    ]
    return api.scene_from_objects(camera, objs)


def build_plain(cfg, resolution, device):
    """The same scene for the plain reference."""
    (sv, sf, suv, sn), (fv, ff), (lv, lf) = _arrays(cfg)

    def t(a):
        a = np.asarray(a)
        return torch.as_tensor(a if a.dtype == np.int64
                               else a.astype(np.float32), device=device)

    cam = cfg["camera"]
    mat = cfg["sphere"]["material"]
    return plain.Scene(
        camera=plain.Camera(t(cam["position"]), t(cam["look_at"]),
                            t(cam["up"]), float(cam["fov"]),
                            int(resolution[0]), int(resolution[1])),
        meshes=[
            plain.Mesh(t(sv), t(sf), uvs=t(suv), normals=t(sn),
                       diffuse=t(mat["diffuse"]), specular=t(mat["specular"]),
                       roughness=t(mat["roughness"])),
            plain.Mesh(t(fv), t(ff), diffuse=t(cfg["floor"]["diffuse"])),
            plain.Mesh(t(lv), t(lf), diffuse=t([0.0, 0.0, 0.0]),
                       emission=t(cfg["light"]["intensity"])),
        ])


def perturbed(traffic, seed):
    """The optimisation's start, drawn from `seed`: for each leaf the
    traffic names, (how, float array) with how "set", "shift" or "scale"
    (the traffic's `perturb` says how far from the target)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 7])
    p = traffic["perturb"]
    out = {}
    for name in traffic["leaves"]:
        if name == "sphere.translation":
            out[name] = ("set", rng.uniform(-1, 1, 3) * p["vertex_shift"])
        elif name in ("camera.position", "camera.look_at"):
            out[name] = ("shift", rng.uniform(-1, 1, 3) * p["camera_shift"])
        elif name == "light.intensity":
            out[name] = ("scale", 1 + rng.uniform(-1, 1, 3)
                         * p["intensity_scale"])
        else:  # a constant reflectance: "sphere.diffuse" -> p["diffuse"]
            lo, hi = p[name.split(".", 1)[1]]
            n = 1 if name == "sphere.roughness" else 3
            out[name] = ("set", rng.uniform(lo, hi, n))
    return out


def apply_start(scene, start, leaves=LEAVES):
    """loops.apply_start on the scene's own device.  leaves: LEAVES for a
    port scene, PLAIN_LEAVES for a reference scene."""
    return loops.apply_start(scene, start, leaves,
                             scene.camera.position.device)


def _translation(leaves):
    return next((t for n, t in leaves if n == "sphere.translation"), None)


def posed(scene, leaves):
    """The port scene to render at the leaves' values: the sphere moved by
    its translation leaf where there is one, else the scene itself."""
    t = _translation(leaves)
    if t is None:
        return scene
    sphere = scene.shapes[0]
    moved = dataclasses.replace(sphere, vertices=sphere.vertices + t)
    return dataclasses.replace(scene,
                               shapes=(moved,) + tuple(scene.shapes[1:]))


def posed_plain(scene, leaves):
    """The same for a reference scene."""
    t = _translation(leaves)
    return scene if t is None else plain.translated(scene, 0, t)
