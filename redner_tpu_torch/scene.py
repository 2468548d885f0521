"""Scene model and the render-ready flattened scene (port of
redner_tpu/scene.py; reference pyredner/scene.py, src/scene.cpp:63-307).

  * `Scene` is the user-facing bundle of Camera/Shape/Material/AreaLight/
    EnvironmentMap.
  * `FlatScene` holds structure-of-arrays buffers built differentiably from
    a Scene on every render, so autograd chains from the flat buffers back
    to the user's leaf tensors: face rows, material tables (constant stacks
    as value tables, textured stacks through one MaterialBank), light
    tables and the packed envmap.  It also carries the ray-query kernels'
    coefficient layout, built once per flatten.

Sampling tables (light PMF/CDF, triangle area CDFs, envmap CDFs) are
detached, matching the reference, which returns no gradients for them
(SURVEY A.3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from redner_tpu_torch.camera import Camera
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.envmap import EnvironmentMap, PackedEnvmap, pack_envmap
from redner_tpu_torch.geometry import Shape, tri_areas
from redner_tpu_torch.light import AreaLight
from redner_tpu_torch.material import LocalMaterial, Material
from redner_tpu_torch.texture import (MaterialBank, PackedTexture, bank_eval,
                                      pack_material_bank, pack_texture,
                                      texture_eval)


@dataclass
class Scene:
    camera: Camera
    shapes: Tuple[Shape, ...]
    materials: Tuple[Material, ...]
    area_lights: Tuple[AreaLight, ...] = ()
    envmap: Optional[EnvironmentMap] = None

    @property
    def num_lights(self):
        return len(self.area_lights) + (1 if self.envmap is not None else 0)


def make_scene(camera, shapes, materials, area_lights=(), envmap=None) -> Scene:
    return Scene(
        camera=camera,
        shapes=tuple(shapes),
        materials=tuple(materials),
        area_lights=tuple(area_lights),
        envmap=envmap,
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

    # Materials, per fetch stack (0 diffuse, 1 specular, 2 roughness,
    # 3 normal map): a stack whose materials are all constant is an (M, C)
    # value table in mat_const; every other stack goes through ONE
    # MaterialBank, indexed by (stack, material id) through mat_itab's
    # fused int row per material (one row gather per lane for all stacks).
    mat_const: Tuple[Optional[torch.Tensor], ...]  # per stack (M, C) | None
    # (M, 12) float row: [uv_scale x4 stacks (8), two_sided,
    # use_vertex_color, compute_specular, has_normal_map].
    mat_ftab: torch.Tensor
    mat_bank: Optional[MaterialBank]
    mat_itab: Optional[torch.Tensor]  # (M, n_bank_stacks*(1+3*Lmax)) int64
    # Per stack, its row-block position in mat_itab, or -1 (constant).
    mat_bank_pos: Tuple[int, ...]
    # Per material, its packed generic texture (the generic_texture AOV
    # channel's only source), or None.
    mat_generic: Tuple[Optional[PackedTexture], ...]

    # Lights
    light_intensity: torch.Tensor  # (L, 3)
    light_two_sided: torch.Tensor  # (L,) bool
    light_directly_visible: torch.Tensor  # (L,) bool
    light_pmf: torch.Tensor  # (num_lights,), the envmap's slot last
    light_cdf: torch.Tensor  # (num_lights,) exclusive scan of pmf
    light_areas: torch.Tensor  # (L,)
    light_tri_cdf: torch.Tensor  # (L, Tmax) exclusive area CDF, 2.0-padded
    light_tri_face: torch.Tensor  # (L, Tmax) global face id (clamped)

    # Environment
    envmap: Optional[PackedEnvmap]

    # Bounds
    bsphere_center: torch.Tensor  # (3,)
    bsphere_radius: torch.Tensor  # ()

    # Static metadata
    num_materials: int
    num_area_lights: int
    has_envmap: bool

    # The ray-query kernels' Morton-ordered coefficient layout
    # (ops.intersect_cuda.CoeffLayout), built once per flatten.
    layout: Optional[object] = None

    # (V,) int64 canonical vertex ids from load-time eps welds (edge
    # keying only); None when no shape carries one.
    weld_ids: Optional[torch.Tensor] = None

    @property
    def num_triangles(self):
        return self.faces.shape[0]

    @property
    def num_lights(self):
        return self.num_area_lights + (1 if self.has_envmap else 0)

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
    # Load-time weld maps composed into global vertex ids; identity for
    # shapes without one.
    weld_ids = None
    if any(s.weld_ids is not None for s in shapes):
        weld_ids = torch.cat([
            (s.weld_ids if s.weld_ids is not None
             else torch.arange(s.num_vertices, **ikw)) + off
            for s, off in zip(shapes, v_off)])

    # Per-corner attributes
    uv_parts, n_parts, hn_parts, c_parts = [], [], [], []
    default_uv = const(_DEFAULT_UV, **kw)
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

    # Materials: 4 fetch stacks (diffuse, specular, roughness, normal).
    stacks = [
        [pack_texture(m.diffuse_reflectance) for m in materials],
        [pack_texture(m.specular_reflectance) for m in materials],
        [pack_texture(m.roughness) for m in materials],
        [pack_texture(m.normal_map) if m.normal_map is not None else None
         for m in materials],
    ]
    mat_const, bank_stacks, mat_bank_pos = [], [], []
    for stack in stacks:
        if all(p is None or p.is_constant for p in stack):
            C = max((p.channels for p in stack if p is not None), default=1)
            rows = []
            for p in stack:
                val = p.flat[0] if p is not None else torch.zeros((C,), **kw)
                if val.shape[-1] < C:
                    val = torch.cat([val,
                                     torch.zeros((C - val.shape[-1],), **kw)])
                rows.append(val)
            mat_const.append(torch.stack(rows))
            mat_bank_pos.append(-1)
        else:
            mat_const.append(None)
            mat_bank_pos.append(len(bank_stacks))
            bank_stacks.append(stack)
    if bank_stacks:
        mat_bank = pack_material_bank(bank_stacks)
        M = len(materials)
        Wrow = mat_bank.tab.shape[-1]
        # (S', M, W) -> (M, S'*W): one fused int row per material.
        mat_itab = (mat_bank.tab.reshape(len(bank_stacks), M, Wrow)
                    .permute(1, 0, 2).reshape(M, len(bank_stacks) * Wrow))
    else:
        mat_bank = mat_itab = None
    uvs_cols = [
        torch.stack([
            (p.uv_scale if p is not None
             else torch.ones((2,), **kw)).to(dtype)
            for p in stack
        ])
        for stack in stacks
    ]
    mat_generic = tuple(
        pack_texture(m.generic_texture) if m.generic_texture is not None
        else None for m in materials)
    mat_ftab = torch.cat(
        uvs_cols
        + [
            const(
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
        light_two_sided = const(
            [l.two_sided for l in scene.area_lights], torch.bool, dev)
        light_directly_visible = const(
            [l.directly_visible for l in scene.area_lights], torch.bool, dev)
        tmax = max(shapes[l.shape_id].num_triangles for l in scene.area_lights)
        tri_cdfs, tri_faces, areas, powers = [], [], [], []
        for l in scene.area_lights:
            s = shapes[l.shape_id]
            F = s.num_triangles
            a = tri_areas(s.vertices.to(dtype), s.indices)
            total = torch.sum(a)
            cdf = vm.cumsum(a, dim=0) - a  # exclusive (src/scene.cpp:47-51)
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

    penv = pack_envmap(scene.envmap) if scene.envmap is not None else None
    if penv is not None:
        surface_area = 4.0 * torch.pi * vm.square(bradius)
        env_power = torch.where(surface_area > 0, surface_area / penv.pdf_norm,
                                torch.ones_like(surface_area))
        power = torch.cat([power, env_power[None]])
    total_power = vm.maximum(torch.sum(power), 1e-20)
    light_pmf = (power / total_power).detach()
    light_cdf = (vm.cumsum(light_pmf, dim=0) - light_pmf).detach()

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
        mat_bank=mat_bank,
        mat_itab=mat_itab,
        mat_bank_pos=tuple(mat_bank_pos),
        mat_generic=mat_generic,
        light_intensity=light_intensity,
        light_two_sided=light_two_sided,
        light_directly_visible=light_directly_visible,
        light_pmf=light_pmf,
        light_cdf=light_cdf,
        light_areas=light_areas,
        light_tri_cdf=light_tri_cdf,
        light_tri_face=light_tri_face,
        envmap=penv,
        bsphere_center=bcenter,
        bsphere_radius=bradius,
        num_materials=len(materials),
        num_area_lights=L,
        has_envmap=penv is not None,
        weld_ids=weld_ids,
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
    """Per-lane material values and flags for shading (the reference's
    per-pixel material pointer fetch, src/texture.h:53-141): one row gather
    per constant stack (the JAX package's one-hot matmul selects the same
    rows exactly), one flag-row gather, and for textured stacks one int-row
    gather shared by all of them plus the bank's 8 texel taps per stack."""
    mid = torch.clamp(material_id, 0, fs.num_materials - 1)
    uv, du, dv = sp.uv, sp.du_dxy, sp.dv_dxy
    frow = fs.mat_ftab[mid]  # (..., 12)
    irow = fs.mat_itab[mid] if fs.mat_itab is not None else None
    Wrow = fs.mat_bank.tab.shape[-1] if fs.mat_bank is not None else 0

    def stack_val(k, channels):
        pos = fs.mat_bank_pos[k]
        if pos < 0:
            val = fs.mat_const[k][mid]
        else:
            uvs = frow[..., 2 * k:2 * k + 2]
            val = bank_eval(fs.mat_bank, irow[..., pos * Wrow:(pos + 1) * Wrow],
                            uv * uvs, du * uvs[..., 0:1], dv * uvs[..., 1:2])
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


def _fetch_material_stack(textures, uv, du_dxy, dv_dxy, mid, channels):
    """Evaluate a per-material texture stack and select by material id ->
    (..., channels), zero-padded; a material without a texture gives zeros
    (redner_tpu/scene.py:443-460)."""
    out = torch.zeros(uv.shape[:-1] + (channels,), dtype=uv.dtype,
                      device=uv.device)
    for m, ptex in enumerate(textures):
        if ptex is None:
            continue
        val = texture_eval(ptex, uv, du_dxy, dv_dxy)
        if val.shape[-1] < channels:
            val = torch.cat(
                [val, torch.zeros(val.shape[:-1] + (channels - val.shape[-1],),
                                  dtype=val.dtype, device=val.device)],
                dim=-1)
        out = torch.where((mid == m)[..., None], val, out)
    return out


# ------------------------------------------------------------------
# Scene leaves (the tensors render_grad.render differentiates)
# ------------------------------------------------------------------


def _map_tensors(obj, fn, floats_only=True):
    """Rebuild obj (a Scene, its dataclasses and tuples) with every float
    tensor t (every tensor, unless floats_only) replaced by fn(t), in a
    fixed traversal order."""
    if torch.is_tensor(obj):
        return fn(obj) if obj.is_floating_point() or not floats_only else obj
    if isinstance(obj, tuple):
        return tuple(_map_tensors(o, fn, floats_only) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn, floats_only)
            for f in dataclasses.fields(obj)})
    return obj


def scene_leaves(scene: Scene) -> list:
    """The scene's float tensors, in a fixed order: the camera's
    position, look-at and up (look-at mode) or cam_to_world, its
    intrinsic_mat and distortion_params; each shape's vertices (and uvs,
    normals, colors);
    each material's texels and uv scales (diffuse, specular, roughness,
    generic texture, normal map); each light's intensity; the envmap's
    texels, uv scale, env_to_world and world_to_env."""
    out = []
    _map_tensors(scene, lambda t: out.append(t) or t)
    return out


def scene_with_leaves(scene: Scene, leaves) -> Scene:
    """The scene with its float tensors replaced, in scene_leaves order."""
    it = iter(leaves)
    return _map_tensors(scene, lambda t: next(it))


def scene_tensors(scene: Scene) -> list:
    """Every tensor of the scene, float and integer alike (indices, weld
    maps, ...), in a fixed traversal order: what a CUDA graph of a render
    reads (graphs.py)."""
    out = []
    _map_tensors(scene, lambda t: out.append(t) or t, floats_only=False)
    return out


def scene_with_tensors(scene: Scene, tensors) -> Scene:
    """The scene with every tensor replaced, in scene_tensors order."""
    it = iter(tensors)
    return _map_tensors(scene, lambda t: next(it), floats_only=False)


def scene_structure(obj):
    """A hashable description of everything of a scene but its tensors'
    values: each tensor's shape, dtype, device and requires_grad, and
    every other field (resolution, camera type, ids, flags, ...) by value.
    Two scenes with equal structures differ only in tensor values, which
    a CUDA graph of a render takes as inputs."""
    if torch.is_tensor(obj):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device,
                obj.requires_grad)
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(scene_structure(o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__qualname__,) + tuple(
            (f.name, scene_structure(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    hash(obj)  # a field that cannot key a cache raises here
    return obj
