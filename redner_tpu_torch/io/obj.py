"""Wavefront OBJ/MTL loading and saving (port of redner_tpu/io/obj.py;
reference pyredner/load_obj.py, save_obj.py, save_mtl.py).

Parsing is host-side numpy; the loaded meshes and materials are tensors on
the device given to load_obj (None = the CUDA card).

Semantics matched to the reference:
  * `load_obj(..., obj_group=True)` splits meshes per material (the
    reference groups faces by the active `usemtl`);
  * per-corner v/vt/vn index triples are kept as separate index arrays
    (uv_indices / normal_indices) unless `use_common_indices`;
  * MTL: Kd -> diffuse, Ks -> specular, Ns (Phong exponent) -> roughness
    2 / (Ns + 2), Ke -> area-light intensity, map_Kd/map_Ks -> textures;
  * `flip_tex_coords=True` flips the v coordinate (OBJ images are
    bottom-up);
  * `weld_eps` attaches a load-time eps weld map (Shape.weld_ids) for
    edge extraction; the geometry keeps its split vertices.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.material import Material, make_material


class TriangleMesh(NamedTuple):
    vertices: torch.Tensor
    indices: torch.Tensor
    uvs: Optional[torch.Tensor]
    normals: Optional[torch.Tensor]
    uv_indices: Optional[torch.Tensor]
    normal_indices: Optional[torch.Tensor]
    # (V,) eps-weld keying map for edge extraction, or None.
    weld_ids: Optional[torch.Tensor] = None


def load_weld_ids(verts: np.ndarray, weld_eps) -> Optional[np.ndarray]:
    """(V,) int32 load-time weld map of a mesh, so that near-duplicate
    split vertices (reduced-precision exports) do not turn every edge into
    a boundary edge.  'auto' keys eps to the mesh scale (1e-6 x the bounding
    box diagonal, the quantization of a %.6g export).  None when nothing
    welds (the map would be the identity) or welding is off; a failure of
    the native helper raises."""
    if weld_eps is None or verts.shape[0] < 2:
        return None
    eps = weld_eps
    if eps == "auto":
        eps = 1e-6 * float(np.linalg.norm(verts.max(0) - verts.min(0)))
    if eps <= 0:
        return None
    from redner_tpu_torch import meshops

    wids = meshops.weld_ids(verts, eps)
    if np.array_equal(wids, np.arange(verts.shape[0], dtype=np.int32)):
        return None
    return wids


def _parse_mtl(path: str, dtype, dev):
    """Parse an MTL file -> {name: Material}, {name: Ke intensity}."""
    materials: Dict[str, Material] = {}
    emissions: Dict[str, np.ndarray] = {}
    if not os.path.exists(path):
        return materials, emissions
    cur = None
    props: Dict[str, object] = {}
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def flush():
        if cur is None:
            return
        Ns = float(props.get("Ns", 0.0))
        roughness = 2.0 / (Ns + 2.0) if Ns > 0 else 1.0
        diffuse = props.get("map_Kd", props.get("Kd", [0.5, 0.5, 0.5]))
        specular = props.get("map_Ks", props.get("Ks", None))
        materials[cur] = make_material(
            diffuse_reflectance=np.asarray(diffuse, np_dtype),
            specular_reflectance=None if specular is None
            else np.asarray(specular, np_dtype),
            roughness=np.asarray([roughness], np_dtype),
            dtype=dtype, device=dev)
        ke = np.asarray(props.get("Ke", [0.0, 0.0, 0.0]), np_dtype)
        if np.any(ke > 0):
            emissions[cur] = ke

    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                flush()
                cur = parts[1] if len(parts) > 1 else ""
                props = {}
            elif key in ("Kd", "Ks", "Ke"):
                props[key] = [float(x) for x in parts[1:4]]
            elif key == "Ns":
                props["Ns"] = parts[1]
            elif key in ("map_Kd", "map_Ks"):
                from redner_tpu_torch.io.image import imread

                # A missing texture file raises (the JAX package's loader
                # drops the texture).
                tex_path = os.path.join(base, " ".join(parts[1:]))
                props[key] = np.asarray(imread(tex_path), np_dtype)
    flush()
    return materials, emissions


def _triangulate(poly: List[Tuple[int, int, int]]):
    """Fan-triangulate a polygon's corner triples."""
    return [(poly[0], poly[i], poly[i + 1]) for i in range(1, len(poly) - 1)]


def _parse_corner(token: str):
    """'v/vt/vn' -> (v, vt, vn), 0 where missing (1-based as in the file)."""
    parts = token.split("/")
    v = int(parts[0])
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    vn = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return (v, vt, vn)


def load_obj(
    filename: str,
    obj_group: bool = True,
    flip_tex_coords: bool = True,
    use_common_indices: bool = False,
    return_objects: bool = False,
    weld_eps="auto",
    dtype=torch.float32,
    device=None,
):
    """Load an OBJ file onto `device` (None = the CUDA card).

    Returns (material_map, mesh_list, light_map) like pyredner.load_obj, or
    a list of Objects when `return_objects=True`:
      material_map: {mtl_name: Material}
      mesh_list: [(mtl_name, TriangleMesh)]
      light_map: {mtl_name: intensity ndarray} for materials with Ke > 0
    weld_eps: the load-time eps weld ("auto" = 1e-6 x bbox diagonal, a
    float, or None for none); only Shape.weld_ids is attached.
    """
    dev = resolve_device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    groups: Dict[str, List] = {}
    order: List[str] = []
    cur_mtl = ""
    materials: Dict[str, Material] = {}
    emissions: Dict[str, np.ndarray] = {}

    base = os.path.dirname(os.path.abspath(filename))
    with open(filename, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                u, v = float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0
                uvs.append([u, 1.0 - v if flip_tex_coords else v])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "f":
                tris = _triangulate([_parse_corner(t) for t in parts[1:]])
                gname = cur_mtl if obj_group else ""
                if gname not in groups:
                    groups[gname] = []
                    order.append(gname)
                groups[gname].extend(tris)
            elif key == "usemtl":
                cur_mtl = " ".join(parts[1:])
            elif key == "mtllib":
                mats, ems = _parse_mtl(
                    os.path.join(base, " ".join(parts[1:])), dtype, dev)
                materials.update(mats)
                emissions.update(ems)

    positions_np = np.asarray(positions, np_dtype)
    uvs_np = np.asarray(uvs, np_dtype) if uvs else None
    normals_np = np.asarray(normals, np_dtype) if normals else None
    nv, nuv, nn = len(positions), len(uvs), len(normals)

    def absidx(i, n):
        # OBJ: positive = 1-based; negative = relative to end; 0 = missing.
        if i > 0:
            return i - 1
        if i < 0:
            return n + i
        return -1

    def ft(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=dev)

    def it(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.int64), device=dev)

    mesh_list = []
    for gname in order:
        tris = groups[gname]
        vidx = np.asarray([[absidx(c[0], nv) for c in tri] for tri in tris],
                          np.int32)
        has_uv = uvs_np is not None and any(
            c[1] != 0 for tri in tris for c in tri)
        has_n = normals_np is not None and any(
            c[2] != 0 for tri in tris for c in tri)
        uvidx = np.asarray([[absidx(c[1], nuv) for c in tri] for tri in tris],
                           np.int32) if has_uv else None
        nidx = np.asarray([[absidx(c[2], nn) for c in tri] for tri in tris],
                          np.int32) if has_n else None
        if use_common_indices and (has_uv or has_n):
            # One shared index buffer: vertices are split per distinct
            # (position, uv, normal) corner triple (pyredner's
            # use_common_indices=True).
            ui = (np.where(uvidx < 0, 0, uvidx) if has_uv
                  else np.zeros_like(vidx))
            ni = (np.where(nidx < 0, 0, nidx) if has_n
                  else np.zeros_like(vidx))
            triples = np.stack([vidx, ui, ni], axis=-1).reshape(-1, 3)
            uniq, inv = np.unique(triples, axis=0, return_inverse=True)
            verts = positions_np[uniq[:, 0]]
            vidx_local = inv.reshape(vidx.shape).astype(np.int32)
            g_uvs = uvs_np[uniq[:, 1]] if has_uv else None
            g_normals = normals_np[uniq[:, 2]] if has_n else None
            g_uvidx = g_nidx = None
        else:
            # Compact the vertices this group uses.
            used, inv = np.unique(vidx.ravel(), return_inverse=True)
            verts = positions_np[used]
            vidx_local = inv.reshape(vidx.shape).astype(np.int32)
            g_uvs = g_uvidx = g_normals = g_nidx = None
            if has_uv:
                uvidx = np.where(uvidx < 0, 0, uvidx)
                u_used, u_inv = np.unique(uvidx.ravel(), return_inverse=True)
                g_uvs = uvs_np[u_used]
                g_uvidx = u_inv.reshape(uvidx.shape).astype(np.int32)
            if has_n:
                nidx = np.where(nidx < 0, 0, nidx)
                n_used, n_inv = np.unique(nidx.ravel(), return_inverse=True)
                g_normals = normals_np[n_used]
                g_nidx = n_inv.reshape(nidx.shape).astype(np.int32)
        mesh_list.append((gname, TriangleMesh(
            vertices=ft(verts), indices=it(vidx_local), uvs=ft(g_uvs),
            normals=ft(g_normals), uv_indices=it(g_uvidx),
            normal_indices=it(g_nidx),
            weld_ids=it(load_weld_ids(verts, weld_eps)))))
        if gname not in materials:
            materials[gname] = make_material(
                diffuse_reflectance=[0.5, 0.5, 0.5], dtype=dtype, device=dev)

    material_map = {name: materials[name] for name, _ in mesh_list}
    light_map = dict(emissions)
    if return_objects:
        from redner_tpu_torch.object import Object

        return [Object(vertices=m.vertices, indices=m.indices,
                       material=material_map[name], uvs=m.uvs,
                       normals=m.normals, uv_indices=m.uv_indices,
                       normal_indices=m.normal_indices,
                       light_intensity=ft(light_map.get(name)),
                       weld_ids=m.weld_ids)
                for name, m in mesh_list]
    return material_map, mesh_list, light_map


def _host(x):
    if x is None:
        return None
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_obj(shape, filename: str, flip_tex_coords: bool = True):
    """Write a Shape (or Object) to OBJ (pyredner/save_obj.py)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    v = _host(shape.vertices)
    f = _host(shape.indices)
    uvs = _host(shape.uvs)
    normals = _host(shape.normals)
    uvi = _host(getattr(shape, "uv_indices", None))
    ni = _host(getattr(shape, "normal_indices", None))
    with open(filename, "w") as out:
        out.write("# generated by redner_tpu_torch\n")
        for p in v:
            out.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if uvs is not None:
            for t in uvs:
                tv = 1.0 - t[1] if flip_tex_coords else t[1]
                out.write(f"vt {t[0]} {tv}\n")
        if normals is not None:
            for nrm in normals:
                out.write(f"vn {nrm[0]} {nrm[1]} {nrm[2]}\n")
        for k, face in enumerate(f):
            toks = []
            for c in range(3):
                vi = face[c] + 1
                ti = None if uvs is None else \
                    (uvi[k][c] if uvi is not None else face[c]) + 1
                nt = None if normals is None else \
                    (ni[k][c] if ni is not None else face[c]) + 1
                if ti is not None and nt is not None:
                    toks.append(f"{vi}/{ti}/{nt}")
                elif ti is not None:
                    toks.append(f"{vi}/{ti}")
                elif nt is not None:
                    toks.append(f"{vi}//{nt}")
                else:
                    toks.append(f"{vi}")
            out.write("f " + " ".join(toks) + "\n")


def save_mtl(material, filename: str, name: str = "material_0"):
    """Write a Material's constant values to MTL (pyredner/save_mtl.py)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as out:
        out.write(f"newmtl {name}\n")
        d = _host(material.diffuse_reflectance.texels)
        if d.ndim == 1:
            out.write(f"Kd {d[0]} {d[1]} {d[2]}\n")
        s = _host(material.specular_reflectance.texels)
        if s.ndim == 1 and np.any(s > 0):
            out.write(f"Ks {s[0]} {s[1]} {s[2]}\n")
        r = _host(material.roughness.texels)
        if r.ndim == 1:
            ns = max(2.0 / max(float(r[0]), 1e-6) - 2.0, 0.0)
            out.write(f"Ns {ns}\n")
