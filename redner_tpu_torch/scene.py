"""Scene model and the render-ready flattened scene (port of
redner_tpu/scene.py; reference pyredner/scene.py, src/scene.cpp:63-307).

  * `Scene` is the user-facing bundle of Camera/Shape/Material/AreaLight.
  * `FlatScene` holds structure-of-arrays buffers built differentiably from
    a Scene on every render, so autograd chains from the flat buffers back
    to the user's leaf tensors.  It also carries the ray-query kernels'
    coefficient layout, built once per flatten.

Sampling tables (light PMF/CDF, triangle area CDFs) are detached, matching
the reference, which returns no gradients for them (SURVEY A.3).
Constant-texture materials only; environment maps are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from redner_tpu_torch.camera import Camera
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.geometry import Shape, tri_areas
from redner_tpu_torch.light import AreaLight
from redner_tpu_torch.material import LocalMaterial, Material
from redner_tpu_torch.texture import pack_texture


@dataclass
class Scene:
    camera: Camera
    shapes: Tuple[Shape, ...]
    materials: Tuple[Material, ...]
    area_lights: Tuple[AreaLight, ...] = ()


def make_scene(camera, shapes, materials, area_lights=(), envmap=None) -> Scene:
    if envmap is not None:
        raise NotImplementedError(
            "redner_tpu_torch: environment maps are not ported yet "
            "(ROADMAP queue A)")
    return Scene(
        camera=camera,
        shapes=tuple(shapes),
        materials=tuple(materials),
        area_lights=tuple(area_lights),
    )


_DEFAULT_UV = [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]


@dataclass
class FlatScene:
    """Render-ready SoA buffers (reference FlattenScene, src/scene.h:21-112)."""

    # Geometry
    vertices: torch.Tensor  # (V, 3) all shapes concatenated
    faces: torch.Tensor  # (F, 3) int64 global vertex ids
    face_shape_id: torch.Tensor  # (F,)
    face_material_id: torch.Tensor  # (F,)
    face_light_id: torch.Tensor  # (F,), -1 if not emissive
    # One differentiable row per face packing [v0|v1|v2 (9), n0|n1|n2 (9),
    # uv0|uv1|uv2 (6), c0|c1|c2 (9), has_normals (1)] = 34 floats.
    face_pack: torch.Tensor  # (F, 34)

    # Materials: per fetch stack (diffuse, specular, roughness, normal map)
    # an (M, C) table of constant values.
    mat_const: Tuple[torch.Tensor, ...]
    # (M, 12) float row: [uv_scale x4 stacks (8), two_sided,
    # use_vertex_color, compute_specular, has_normal_map].
    mat_ftab: torch.Tensor

    # Lights
    light_intensity: torch.Tensor  # (L, 3)
    light_two_sided: torch.Tensor  # (L,) bool
    light_directly_visible: torch.Tensor  # (L,) bool
    light_pmf: torch.Tensor  # (L,)
    light_cdf: torch.Tensor  # (L,) exclusive scan of pmf
    light_areas: torch.Tensor  # (L,)
    light_tri_cdf: torch.Tensor  # (L, Tmax) exclusive area CDF, 2.0-padded
    light_tri_face: torch.Tensor  # (L, Tmax) global face id (clamped)

    # Bounds
    bsphere_center: torch.Tensor  # (3,)
    bsphere_radius: torch.Tensor  # ()

    # Static metadata
    num_materials: int
    num_area_lights: int

    # The ray-query kernels' Morton-ordered coefficient layout
    # (ops.intersect_cuda.CoeffLayout), built once per flatten.
    layout: Optional[object] = None

    @property
    def num_triangles(self):
        return self.faces.shape[0]

    @property
    def num_lights(self):
        return self.num_area_lights

    @property
    def device(self):
        return self.vertices.device


def flatten_scene(scene: Scene, dtype=torch.float32) -> FlatScene:
    """Differentiably flatten a Scene into FlatScene buffers
    (reference Scene constructor + get_flatten_scene, src/scene.cpp:63-410)."""
    shapes = scene.shapes
    materials = scene.materials
    if len(shapes) == 0:
        raise ValueError("scene needs at least one shape")
    dev = shapes[0].vertices.device
    kw = dict(dtype=dtype, device=dev)
    ikw = dict(dtype=torch.int64, device=dev)

    v_off = []
    f_off = []
    vo = fo = 0
    for s in shapes:
        v_off.append(vo)
        f_off.append(fo)
        vo += s.num_vertices
        fo += s.num_triangles

    verts = torch.cat([s.vertices for s in shapes], dim=0).to(dtype)
    faces = torch.cat([s.indices + off for s, off in zip(shapes, v_off)], dim=0)
    face_shape_id = torch.cat(
        [torch.full((s.num_triangles,), i, **ikw) for i, s in enumerate(shapes)])
    face_material_id = torch.cat(
        [torch.full((s.num_triangles,), s.material_id, **ikw) for s in shapes])
    face_light_id = torch.cat(
        [torch.full((s.num_triangles,), s.light_id, **ikw) for s in shapes])

    # Per-corner attributes
    uv_parts, n_parts, hn_parts, c_parts = [], [], [], []
    default_uv = torch.tensor(_DEFAULT_UV, **kw)
    for s in shapes:
        F = s.num_triangles
        if s.uvs is not None:
            uvi = s.uv_indices if s.uv_indices is not None else s.indices
            uv_parts.append(s.uvs[uvi])  # (F, 3, 2)
        else:
            uv_parts.append(default_uv.expand(F, 3, 2))
        if s.normals is not None:
            ni = s.normal_indices if s.normal_indices is not None else s.indices
            n_parts.append(s.normals[ni])
            hn_parts.append(torch.ones((F,), dtype=torch.bool, device=dev))
        else:
            n_parts.append(torch.zeros((F, 3, 3), **kw))
            hn_parts.append(torch.zeros((F,), dtype=torch.bool, device=dev))
        if s.colors is not None:
            c_parts.append(s.colors[s.indices])
        else:
            c_parts.append(torch.zeros((F, 3, 3), **kw))
    face_uvs = torch.cat(uv_parts, dim=0)
    face_normals = torch.cat(n_parts, dim=0)
    face_has_normals = torch.cat(hn_parts, dim=0)
    face_colors = torch.cat(c_parts, dim=0)

    # Materials: 4 fetch stacks (diffuse, specular, roughness, normal), each
    # an (M, C) table of constants (pack_texture raises on image textures).
    stacks = [
        [pack_texture(m.diffuse_reflectance) for m in materials],
        [pack_texture(m.specular_reflectance) for m in materials],
        [pack_texture(m.roughness) for m in materials],
        [None for m in materials],  # normal maps: not ported yet
    ]
    mat_const = []
    for stack in stacks:
        C = max((p.channels for p in stack if p is not None), default=1)
        rows = []
        for p in stack:
            val = p.flat[0] if p is not None else torch.zeros((C,), **kw)
            if val.shape[-1] < C:
                val = torch.cat([val, torch.zeros((C - val.shape[-1],), **kw)])
            rows.append(val)
        mat_const.append(torch.stack(rows))
    uvs_cols = [
        torch.stack([
            (p.uv_scale if p is not None
             else torch.ones((2,), **kw)).to(dtype)
            for p in stack
        ])
        for stack in stacks
    ]
    mat_ftab = torch.cat(
        uvs_cols
        + [
            torch.tensor(
                [[float(m.two_sided),
                  float(m.use_vertex_color),
                  float(m.compute_specular_lighting),
                  float(m.normal_map is not None)] for m in materials],
                **kw,
            )
        ],
        dim=-1,
    )  # (M, 12)

    # Bounding sphere (axis-aligned box midpoint, src/scene.cpp:157-195)
    vmin = torch.min(verts, dim=0).values
    vmax = torch.max(verts, dim=0).values
    bcenter = 0.5 * (vmin + vmax)
    bradius = 0.5 * vm.length(vmax - vmin)

    # Lights + sampling tables (src/scene.cpp:197-253)
    L = len(scene.area_lights)
    if L > 0:
        light_intensity = torch.stack(
            [l.intensity for l in scene.area_lights]).to(dtype)
        light_two_sided = torch.tensor(
            [l.two_sided for l in scene.area_lights], dtype=torch.bool,
            device=dev)
        light_directly_visible = torch.tensor(
            [l.directly_visible for l in scene.area_lights], dtype=torch.bool,
            device=dev)
        tmax = max(shapes[l.shape_id].num_triangles for l in scene.area_lights)
        tri_cdfs, tri_faces, areas, powers = [], [], [], []
        for l in scene.area_lights:
            s = shapes[l.shape_id]
            F = s.num_triangles
            a = tri_areas(s.vertices.to(dtype), s.indices)
            total = torch.sum(a)
            cdf = torch.cumsum(a, dim=0) - a  # exclusive (src/scene.cpp:47-51)
            cdf = cdf / vm.maximum(total, 1e-20)
            pad = tmax - F
            cdf = torch.cat([cdf, torch.full((pad,), 2.0, **kw)])
            gface = torch.arange(F, **ikw) + f_off[l.shape_id]
            gface = torch.cat(
                [gface, torch.full((pad,), f_off[l.shape_id] + F - 1, **ikw)])
            tri_cdfs.append(cdf)
            tri_faces.append(gface)
            areas.append(total)
            powers.append(total * vm.luminance(l.intensity) * torch.pi)
        light_tri_cdf = torch.stack(tri_cdfs).detach()
        light_tri_face = torch.stack(tri_faces)
        light_areas = torch.stack(areas).detach()
        power = torch.stack(powers)
    else:
        light_intensity = torch.zeros((0, 3), **kw)
        light_two_sided = torch.zeros((0,), dtype=torch.bool, device=dev)
        light_directly_visible = torch.zeros((0,), dtype=torch.bool, device=dev)
        light_tri_cdf = torch.zeros((0, 1), **kw)
        light_tri_face = torch.zeros((0, 1), **ikw)
        light_areas = torch.zeros((0,), **kw)
        power = torch.zeros((0,), **kw)

    total_power = vm.maximum(torch.sum(power), 1e-20)
    light_pmf = (power / total_power).detach()
    light_cdf = (torch.cumsum(light_pmf, dim=0) - light_pmf).detach()

    face_pack = torch.cat(
        [
            verts[faces[:, 0]],
            verts[faces[:, 1]],
            verts[faces[:, 2]],
            face_normals.reshape(-1, 9),
            face_uvs.reshape(-1, 6),
            face_colors.reshape(-1, 9),
            face_has_normals.to(dtype)[:, None],
        ],
        dim=-1,
    )

    fs = FlatScene(
        vertices=verts,
        faces=faces,
        face_pack=face_pack,
        face_shape_id=face_shape_id,
        face_material_id=face_material_id,
        face_light_id=face_light_id,
        mat_const=tuple(mat_const),
        mat_ftab=mat_ftab,
        light_intensity=light_intensity,
        light_two_sided=light_two_sided,
        light_directly_visible=light_directly_visible,
        light_pmf=light_pmf,
        light_cdf=light_cdf,
        light_areas=light_areas,
        light_tri_cdf=light_tri_cdf,
        light_tri_face=light_tri_face,
        bsphere_center=bcenter,
        bsphere_radius=bradius,
        num_materials=len(materials),
        num_area_lights=L,
    )
    from redner_tpu_torch.ops.intersect_cuda import coeff_layout_build

    fs.layout = coeff_layout_build(fs)
    return fs


# ------------------------------------------------------------------
# Per-lane accessors
# ------------------------------------------------------------------


def _face_rows(fs: FlatScene, tri_id):
    return fs.face_pack[torch.clamp(tri_id, 0, fs.num_triangles - 1)]


def gather_face_vertices(fs: FlatScene, tri_id):
    """Per-corner world positions for (clamped) triangle ids (..., 3)x3,
    from one wide face_pack row gather."""
    row = _face_rows(fs, tri_id)
    return row[..., 0:3], row[..., 3:6], row[..., 6:9]


def gather_face_corner_attribs(fs: FlatScene, tri_id):
    """(uv0,uv1,uv2, n0,n1,n2, has_normals, c0,c1,c2) for triangle ids."""
    row = _face_rows(fs, tri_id)
    return (
        row[..., 18:20], row[..., 20:22], row[..., 22:24],
        row[..., 9:12], row[..., 12:15], row[..., 15:18],
        row[..., 33] > 0.5,
        row[..., 24:27], row[..., 27:30], row[..., 30:33],
    )


def fetch_local_material(fs: FlatScene, sp, material_id) -> LocalMaterial:
    """Per-lane material values and flags for shading: one row gather per
    constant stack (the JAX package's one-hot matmul selects the same rows
    exactly) plus one flag-row gather."""
    mid = torch.clamp(material_id, 0, fs.num_materials - 1)
    frow = fs.mat_ftab[mid]  # (..., 12)

    def stack_val(k, channels):
        val = fs.mat_const[k][mid]
        if val.shape[-1] < channels:
            val = torch.cat(
                [val, torch.zeros(val.shape[:-1] + (channels - val.shape[-1],),
                                  dtype=val.dtype, device=val.device)],
                dim=-1,
            )
        return val[..., :channels]

    return LocalMaterial(
        diffuse=stack_val(0, 3),
        specular=stack_val(1, 3),
        roughness=stack_val(2, 1)[..., 0],
        normal_value=stack_val(3, 3),
        two_sided=frow[..., 8] > 0.5,
        use_vertex_color=frow[..., 9] > 0.5,
        compute_specular=frow[..., 10] > 0.5,
        has_normal_map=frow[..., 11] > 0.5,
    )
