"""Mitsuba 0.x XML scene loader (port of redner_tpu/io/mitsuba.py;
reference pyredner/load_mitsuba.py).

Parses sensors (a perspective camera from `toWorld` with x flipped and the
film's resolution), shapes (obj / serialized / rectangle / sphere / cube /
shapegroup+instance), bsdfs (diffuse with bitmap textures / roughplastic /
plastic / roughdielectric / twosided / mask), emitters (area, envmap,
point/spot as a small emissive sphere) and transforms (matrix / translate /
rotate / scale / lookat) into a redner_tpu_torch Scene on one device.
Every mesh gets its load-time eps weld (Shape.weld_ids), as the reference
rebuilds topology on every Mitsuba mesh (pyredner/load_mitsuba.py:296).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from redner_tpu_torch.camera import make_camera
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.envmap import make_environment_map
from redner_tpu_torch.geometry import make_shape
from redner_tpu_torch.io.image import imread
from redner_tpu_torch.io.obj import load_obj, load_weld_ids
from redner_tpu_torch.io.serialized import load_serialized
from redner_tpu_torch.light import make_area_light
from redner_tpu_torch.material import Material, make_material
from redner_tpu_torch.scene import make_scene
from redner_tpu_torch.utils import generate_sphere


def _parse_vec(s: str):
    parts = s.replace(",", " ").split()
    return np.asarray([float(x) for x in parts], np.float32)


def parse_transform(node) -> np.ndarray:
    """Accumulate child transforms left-to-right into a 4x4 matrix."""
    m = np.eye(4, dtype=np.float32)
    for child in node:
        tag = child.tag.lower()
        if tag == "matrix":
            mm = _parse_vec(child.attrib["value"]).reshape(4, 4)
            m = mm @ m
        elif tag == "translate":
            t = np.eye(4, dtype=np.float32)
            t[0, 3] = float(child.attrib.get("x", 0))
            t[1, 3] = float(child.attrib.get("y", 0))
            t[2, 3] = float(child.attrib.get("z", 0))
            m = t @ m
        elif tag == "scale":
            s = np.eye(4, dtype=np.float32)
            if "value" in child.attrib:
                v = float(child.attrib["value"])
                s[0, 0] = s[1, 1] = s[2, 2] = v
            else:
                s[0, 0] = float(child.attrib.get("x", 1))
                s[1, 1] = float(child.attrib.get("y", 1))
                s[2, 2] = float(child.attrib.get("z", 1))
            m = s @ m
        elif tag == "rotate":
            axis = np.asarray(
                [
                    float(child.attrib.get("x", 0)),
                    float(child.attrib.get("y", 0)),
                    float(child.attrib.get("z", 0)),
                ],
                np.float32,
            )
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            ang = np.radians(float(child.attrib["angle"]))
            c, s_, t = np.cos(ang), np.sin(ang), 1 - np.cos(ang)
            x, y, z = axis
            r = np.eye(4, dtype=np.float32)
            r[:3, :3] = np.asarray(
                [
                    [t * x * x + c, t * x * y - s_ * z, t * x * z + s_ * y],
                    [t * x * y + s_ * z, t * y * y + c, t * y * z - s_ * x],
                    [t * x * z - s_ * y, t * y * z + s_ * x, t * z * z + c],
                ],
                np.float32,
            )
            m = r @ m
        elif tag == "lookat":
            origin = _parse_vec(child.attrib["origin"])
            target = _parse_vec(child.attrib["target"])
            up = _parse_vec(child.attrib["up"])
            fwd = target - origin
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(up / np.linalg.norm(up), fwd)
            right /= max(np.linalg.norm(right), 1e-12)
            new_up = np.cross(fwd, right)
            lk = np.eye(4, dtype=np.float32)
            lk[:3, 0] = right
            lk[:3, 1] = new_up
            lk[:3, 2] = fwd
            lk[:3, 3] = origin
            m = lk @ m
    return m


def _rgb_of(node, name, default):
    for child in node.iter():
        if child.attrib.get("name") == name and child.tag in (
            "rgb",
            "spectrum",
            "srgb",
        ):
            v = _parse_vec(child.attrib["value"])
            if v.size == 1:
                v = np.repeat(v, 3)
            return v
        if child.attrib.get("name") == name and child.tag == "float":
            v = float(child.attrib["value"])
            return np.asarray([v, v, v], np.float32)
    return np.asarray(default, np.float32)


def _float_of(node, name, default):
    for child in node.iter():
        if child.attrib.get("name") == name and child.tag == "float":
            return float(child.attrib["value"])
    return default


def _parse_texture(node, name: str, base_dir: str):
    """Bitmap texture under `node` named `name`, honoring the reference's
    `scale` wrapper (pyredner/load_mitsuba.py:127-140): a texture of type
    'scale' multiplies an inner bitmap by a scale float."""
    for child in node:
        if child.tag != "texture" or child.attrib.get("name") != name:
            continue
        scale = 1.0
        target = child
        if child.attrib.get("type") == "scale":
            scale = _float_of(child, "scale", 1.0)
            inner = child.find("texture")
            if inner is not None:
                target = inner
        for sub in target.iter():
            if sub.attrib.get("name") == "filename":
                # A missing texture file raises (the JAX package's loader
                # drops the texture).
                path = os.path.join(base_dir, sub.attrib["value"])
                return scale * np.asarray(imread(path), np.float32)
    return None


def parse_bsdf(node, base_dir: str, dev):
    """BSDF node -> (id, Material on device dev)."""
    btype = node.attrib.get("type", "diffuse")
    bid = node.attrib.get("id", "")
    if btype == "twosided":
        inner = node.find("bsdf")
        _, mat = parse_bsdf(inner, base_dir, dev)
        return bid, dataclasses.replace(mat, two_sided=True)
    if btype == "mask":
        # Opacity masks are unsupported (reference prints the same TODO,
        # pyredner/load_mitsuba.py:223-226); use the inner bsdf.
        inner = node.find("bsdf")
        if inner is not None:
            return bid, parse_bsdf(inner, base_dir, dev)[1]
    if btype in ("roughdielectric", "dielectric", "thindielectric"):
        # No transmission model (the reference path tracer has none
        # either); fall back to a glossy coat over white diffuse.
        specular = _rgb_of(node, "specularReflectance", [1.0, 1.0, 1.0])
        alpha = _float_of(node, "alpha", 0.1)
        return bid, make_material(
            diffuse_reflectance=np.asarray([0.8, 0.8, 0.8], np.float32),
            specular_reflectance=specular,
            roughness=np.asarray([max(alpha * alpha, 1e-4)], np.float32),
            device=dev,
        )
    if btype in ("roughplastic", "plastic", "roughconductor", "conductor"):
        diffuse = _rgb_of(node, "diffuseReflectance", [0.5, 0.5, 0.5])
        specular = _rgb_of(node, "specularReflectance", [1.0, 1.0, 1.0])
        alpha = _float_of(node, "alpha", 0.01)
        return bid, make_material(
            diffuse_reflectance=diffuse,
            specular_reflectance=specular,
            roughness=np.asarray([alpha * alpha], np.float32),
            device=dev,
        )
    # diffuse / fallback
    reflectance = _rgb_of(node, "reflectance", [0.5, 0.5, 0.5])
    tex = _parse_texture(node, "reflectance", base_dir)
    # Mitsuba smooth-diffuse shades both sides; match that default.
    return bid, make_material(
        diffuse_reflectance=tex if tex is not None else reflectance,
        two_sided=True,
        device=dev,
    )


_RECT_VERTS = np.asarray(
    [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
)
_RECT_IDX = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)

# Unit cube [-1, 1]^3, outward-facing winding.
_CUBE_VERTS = np.asarray(
    [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)],
    np.float32,
)
_CUBE_IDX = np.asarray(
    [
        [0, 1, 3], [0, 3, 2],  # x = -1
        [4, 7, 5], [4, 6, 7],  # x = +1
        [0, 4, 5], [0, 5, 1],  # y = -1
        [2, 3, 7], [2, 7, 6],  # y = +1
        [0, 2, 6], [0, 6, 4],  # z = -1
        [1, 5, 7], [1, 7, 3],  # z = +1
    ],
    np.int32,
)

_PLACEHOLDER_VERTS = np.asarray(
    [[0, 0, 0], [1e-4, 0, 0], [0, 1e-4, 0]], np.float32
)
_PLACEHOLDER_IDX = np.asarray([[0, 1, 2]], np.int32)


def _point_of(node, name, default):
    for child in node.iter():
        if child.attrib.get("name") == name and child.tag == "point":
            if "value" in child.attrib:
                return _parse_vec(child.attrib["value"])
            return np.asarray(
                [float(child.attrib.get(a, 0.0)) for a in ("x", "y", "z")],
                np.float32,
            )
    return np.asarray(default, np.float32)


def _shape_geometry(node, base_dir: str, on_missing_mesh: str):
    """(verts, idx, uvs, normals) for one shape node, or None."""
    stype = node.attrib["type"]
    fname = None
    serialized_idx = 0
    for child in node:
        if child.tag == "string" and child.attrib.get("name") == "filename":
            fname = child.attrib["value"]
        elif child.tag == "integer" and child.attrib.get("name") == "shapeIndex":
            serialized_idx = int(child.attrib["value"])

    if stype in ("obj", "serialized") and fname:
        path = os.path.join(base_dir, fname)
        if not os.path.exists(path):
            if on_missing_mesh == "placeholder":
                return (_PLACEHOLDER_VERTS.copy(), _PLACEHOLDER_IDX.copy(),
                        None, None)
            raise FileNotFoundError(path)
        if stype == "obj":
            # The shape's weld is made on its world-space vertices below.
            _, mesh_list, _ = load_obj(path, weld_eps=None, device="cpu")
            if not mesh_list:
                return None
            _, mesh = mesh_list[0]
            host = lambda x: None if x is None else x.numpy()
            return (host(mesh.vertices), host(mesh.indices).astype(np.int32),
                    host(mesh.uvs), host(mesh.normals))
        m = load_serialized(path, serialized_idx)
        return (np.asarray(m.vertices), np.asarray(m.indices),
                None if m.uvs is None else np.asarray(m.uvs),
                None if m.normals is None else np.asarray(m.normals))
    if stype == "rectangle":
        return _RECT_VERTS.copy(), _RECT_IDX.copy(), None, None
    if stype == "cube":
        return _CUBE_VERTS.copy(), _CUBE_IDX.copy(), None, None
    if stype == "sphere":
        radius = _float_of(node, "radius", 1.0)
        center = _point_of(node, "center", [0.0, 0.0, 0.0])
        v, i, uv, nrm = (x.numpy() for x in generate_sphere(32, 64,
                                                             device="cpu"))
        return (v * radius + center[None, :], i.astype(np.int32), uv, nrm)
    return None


def load_mitsuba(filename: str, on_missing_mesh: str = "error",
                 device=None):
    """Parse a Mitsuba 0.x XML file -> Scene on `device` (None = the CUDA
    card).

    on_missing_mesh: 'error' raises when a referenced obj/serialized file
    is absent; 'placeholder' substitutes a degenerate micro-triangle so the
    scene's structure (materials, lights, camera, transforms) still loads.
    """
    dev = resolve_device(device)
    root = ET.parse(filename).getroot()
    base_dir = os.path.dirname(os.path.abspath(filename))

    camera = None
    materials: List[Material] = []
    mat_by_id: Dict[str, int] = {}
    shapes = []
    lights = []
    envmap = None
    shape_groups: Dict[str, tuple] = {}  # id -> (verts, idx, uvs, normals)

    def material_index(mat, mid):
        if mid and mid in mat_by_id:
            return mat_by_id[mid]
        idx = len(materials)
        materials.append(mat)
        if mid:
            mat_by_id[mid] = idx
        return idx

    for node in root:
        if node.tag == "sensor":
            fov = _float_of(node, "fov", 45.0)
            to_world = np.eye(4, dtype=np.float32)
            res = [256, 256]
            for child in node:
                if child.tag == "transform":
                    to_world = parse_transform(child)
                if child.tag == "film":
                    for sub in child.iter():
                        if sub.attrib.get("name") == "width":
                            res[1] = int(sub.attrib["value"])
                        if sub.attrib.get("name") == "height":
                            res[0] = int(sub.attrib["value"])
            # Mitsuba looks down +z with x left; flip x to match our frame.
            flip = np.diag(np.asarray([-1.0, 1.0, 1.0, 1.0], np.float32))
            f = 1.0 / np.tan(np.radians(0.5 * fov))
            camera = make_camera(
                cam_to_world=to_world @ flip,
                intrinsic_mat=np.diag(np.asarray([f, f, 1.0], np.float32)),
                resolution=(res[0], res[1]), device=dev)
        elif node.tag == "bsdf":
            bid, mat = parse_bsdf(node, base_dir, dev)
            material_index(mat, bid)
        elif node.tag == "shape":
            stype = node.attrib["type"]
            to_world = np.eye(4, dtype=np.float32)
            mat_idx = None
            emission = None
            for child in node:
                if child.tag == "transform":
                    to_world = parse_transform(child)
                elif child.tag == "ref":
                    rid = child.attrib.get("id")
                    if rid in mat_by_id:
                        mat_idx = mat_by_id[rid]
                elif child.tag == "bsdf":
                    _, m = parse_bsdf(child, base_dir, dev)
                    mat_idx = material_index(m, child.attrib.get("id", ""))
                elif child.tag == "emitter":
                    emission = _rgb_of(child, "radiance", [1.0, 1.0, 1.0])

            if stype == "shapegroup":
                # Instanced geometry container (pyredner/load_mitsuba.py:
                # 435-438): its first child shape serves later instances.
                gid = node.attrib.get("id", "")
                for child in node:
                    if child.tag == "shape":
                        geo = _shape_geometry(child, base_dir, on_missing_mesh)
                        if geo is not None:
                            shape_groups[gid] = geo
                        break
                continue
            geo = None
            if stype == "instance":
                for child in node:
                    # Only shapegroup refs carry geometry.
                    if child.tag == "ref" and child.attrib.get("id") in \
                            shape_groups:
                        geo = shape_groups[child.attrib["id"]]
            else:
                geo = _shape_geometry(node, base_dir, on_missing_mesh)
            if geo is None:
                continue
            verts, idx, uvs, normals = geo
            vh = np.concatenate([verts, np.ones((verts.shape[0], 1),
                                                np.float32)], 1)
            verts_w = (vh @ to_world.T)[:, :3]
            if normals is not None:
                nmat = np.linalg.inv(to_world[:3, :3]).T
                normals = normals @ nmat.T
                norm = np.linalg.norm(normals, axis=-1, keepdims=True)
                normals = normals / np.maximum(norm, 1e-12)
            if mat_idx is None:
                mat_idx = material_index(make_material(
                    diffuse_reflectance=[0.5, 0.5, 0.5], two_sided=True,
                    device=dev), "")
            light_id = -1
            if emission is not None:
                light_id = len(lights)
                lights.append(make_area_light(len(shapes), emission,
                                              two_sided=True, device=dev))
            shapes.append(make_shape(
                vertices=verts_w, indices=idx, uvs=uvs, normals=normals,
                material_id=mat_idx, light_id=light_id,
                weld_ids=load_weld_ids(np.asarray(verts_w, np.float32),
                                       "auto"),
                device=dev))
        elif node.tag == "emitter":
            etype = node.attrib.get("type")
            if etype in ("point", "spot"):
                # Area lights only (as in the reference): a point/spot
                # emitter becomes a small emissive sphere of the same
                # flux, L = I / (pi r^2) for radiant intensity I.
                pos = _point_of(node, "position", [0.0, 0.0, 0.0])
                for child in node:
                    if child.tag == "transform":
                        pos = parse_transform(child)[:3, 3]
                intensity = _rgb_of(node, "intensity", [1.0, 1.0, 1.0])
                r = 0.05
                v, i, _, _ = (x.numpy() for x in generate_sphere(
                    8, 16, device="cpu"))
                mat_idx = material_index(make_material(
                    diffuse_reflectance=np.zeros(3, np.float32), device=dev),
                    "")
                light_id = len(lights)
                lights.append(make_area_light(
                    len(shapes), intensity / (np.pi * r * r), two_sided=True,
                    device=dev))
                shapes.append(make_shape(
                    vertices=v * r + np.asarray(pos)[None, :], indices=i,
                    material_id=mat_idx, light_id=light_id, device=dev))
            elif etype == "envmap":
                fname = None
                to_world = np.eye(4, dtype=np.float32)
                for child in node:
                    if child.tag == "string" and \
                            child.attrib.get("name") == "filename":
                        fname = child.attrib["value"]
                    if child.tag == "transform":
                        to_world = parse_transform(child)
                if fname:
                    envmap = make_environment_map(
                        imread(os.path.join(base_dir, fname)),
                        env_to_world=to_world, device=dev)

    if camera is None:
        raise ValueError(f"{filename}: the Mitsuba scene has no sensor")
    return make_scene(camera, shapes, materials, area_lights=lights,
                      envmap=envmap)
