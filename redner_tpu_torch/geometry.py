"""Triangle mesh geometry (port of redner_tpu/geometry.py): shapes,
Moller-Trumbore with ray-differential carry, surface-point construction,
uniform triangle sampling.

Everything is batched over a leading pixel axis and written with
gradient-safe guards so masked lanes cannot produce NaN gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import Ray, RayDifferential, SurfacePoint
from redner_tpu_torch.device import resolve_device


@dataclass
class Shape:
    """A triangle mesh (reference: pyredner/shape.py:327-429)."""

    vertices: torch.Tensor  # (V, 3) float
    indices: torch.Tensor  # (F, 3) int64
    uvs: Optional[torch.Tensor] = None  # (U, 2)
    normals: Optional[torch.Tensor] = None  # (N, 3)
    uv_indices: Optional[torch.Tensor] = None  # (F, 3)
    normal_indices: Optional[torch.Tensor] = None  # (F, 3)
    colors: Optional[torch.Tensor] = None  # (V, 3)
    material_id: int = 0
    light_id: int = -1

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_triangles(self):
        return self.indices.shape[0]


def make_shape(vertices, indices, uvs=None, normals=None, uv_indices=None,
               normal_indices=None, colors=None, material_id=0, light_id=-1,
               dtype=torch.float32, device=None) -> Shape:
    dev = resolve_device(device)
    cast = lambda x: None if x is None else torch.as_tensor(
        x, dtype=dtype, device=dev)
    icast = lambda x: None if x is None else torch.as_tensor(
        x, dtype=torch.int64, device=dev)
    return Shape(
        vertices=cast(vertices),
        indices=icast(indices),
        uvs=cast(uvs),
        normals=cast(normals),
        uv_indices=icast(uv_indices),
        normal_indices=icast(normal_indices),
        colors=cast(colors),
        material_id=int(material_id),
        light_id=int(light_id),
    )


MT_EPS = 1e-8  # Moller-Trumbore divisor clamp (src/intersection.h:73-80)


def intersect_tri(v0, v1, v2, ray: Ray, ray_diff: RayDifferential):
    """Batched Moller-Trumbore returning (u, v, t) and their screen derivs.

    The divisor is clamped to +/-1e-8 preserving sign, like the reference.
    No hit test here: the caller masks on 0<=u, 0<=v, u+v<=1, t in range.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vm.cross(ray.dir, e2)
    pvec_dx = vm.cross(ray_diff.dir_dx, e2)
    pvec_dy = vm.cross(ray_diff.dir_dy, e2)
    divisor = vm.dot(pvec, e1)
    divisor_dx = vm.dot(pvec_dx, e1)
    divisor_dy = vm.dot(pvec_dy, e1)
    sign = torch.where(divisor >= 0, 1.0, -1.0).to(divisor.dtype)
    divisor = sign * vm.maximum(torch.abs(divisor), MT_EPS)
    inv_div = 1.0 / divisor
    s = ray.org - v0
    s_dx = ray_diff.org_dx
    s_dy = ray_diff.org_dy
    dot_s_pvec = vm.dot(s, pvec)
    dot_s_pvec_dx = vm.dot(s_dx, pvec) + vm.dot(s, pvec_dx)
    dot_s_pvec_dy = vm.dot(s_dy, pvec) + vm.dot(s, pvec_dy)
    u = dot_s_pvec * inv_div
    u_dx = (dot_s_pvec_dx - u * divisor_dx) * inv_div
    u_dy = (dot_s_pvec_dy - u * divisor_dy) * inv_div
    qvec = vm.cross(s, e1)
    qvec_dx = vm.cross(s_dx, e1)
    qvec_dy = vm.cross(s_dy, e1)
    dot_dir_qvec = vm.dot(ray.dir, qvec)
    dot_dir_qvec_dx = vm.dot(ray_diff.dir_dx, qvec) + vm.dot(ray.dir, qvec_dx)
    dot_dir_qvec_dy = vm.dot(ray_diff.dir_dy, qvec) + vm.dot(ray.dir, qvec_dy)
    v = dot_dir_qvec * inv_div
    v_dx = (dot_dir_qvec_dx - v * divisor_dx) * inv_div
    v_dy = (dot_dir_qvec_dy - v * divisor_dy) * inv_div
    dot_e2_qvec = vm.dot(e2, qvec)
    dot_e2_qvec_dx = vm.dot(e2, qvec_dx)
    dot_e2_qvec_dy = vm.dot(e2, qvec_dy)
    t = dot_e2_qvec * inv_div
    t_dx = (dot_e2_qvec_dx - t * divisor_dx) * inv_div
    t_dy = (dot_e2_qvec_dy - t * divisor_dy) * inv_div
    uvt = torch.stack([u, v, t], dim=-1)
    u_dxy = torch.stack([u_dx, u_dy], dim=-1)
    v_dxy = torch.stack([v_dx, v_dy], dim=-1)
    t_dxy = torch.stack([t_dx, t_dy], dim=-1)
    return uvt, u_dxy, v_dxy, t_dxy


def build_surface_point(
    v0, v1, v2,
    uv0, uv1, uv2,
    n0, n1, n2, has_normals,
    c0, c1, c2,
    ray: Ray,
    ray_diff: RayDifferential,
):
    """Differentiable surface point at the ray-triangle intersection
    (reference: src/shape.h:259-383).  Returns (SurfacePoint, new
    RayDifferential)."""
    uvt, u_dxy, v_dxy, t_dxy = intersect_tri(v0, v1, v2, ray, ray_diff)
    u, v, t = uvt[..., 0], uvt[..., 1], uvt[..., 2]
    w = 1.0 - (u + v)
    uv = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2
    hit_pos = ray.org + ray.dir * t[..., None]
    geom_normal = vm.normalize(vm.cross(v1 - v0, v2 - v0))

    # Triangle uv-parameterization derivatives -> dpdu (shading tangent)
    uvs02 = uv0 - uv2
    uvs12 = uv1 - uv2
    uv_det = uvs02[..., 0] * uvs12[..., 1] - uvs02[..., 1] * uvs12[..., 0]
    uv_ok = uv_det != 0.0
    inv_det = torch.where(
        uv_ok, 1.0 / torch.where(uv_ok, uv_det, torch.ones_like(uv_det)),
        torch.zeros_like(uv_det))
    v02 = v0 - v2
    v12 = v1 - v2
    dpdu = (uvs12[..., 1:2] * v02 - uvs02[..., 1:2] * v12) * inv_det[..., None]
    cs_x, _ = vm.coordinate_system(geom_normal)
    dpdu = torch.where(uv_ok[..., None], dpdu, cs_x)

    # Screen-space footprint derivatives
    du_dxy = ((-u_dxy - v_dxy) * uv0[..., 0:1] + u_dxy * uv1[..., 0:1]
              + v_dxy * uv2[..., 0:1])
    dv_dxy = ((-u_dxy - v_dxy) * uv0[..., 1:2] + u_dxy * uv1[..., 1:2]
              + v_dxy * uv2[..., 1:2])
    dpdx = (ray_diff.org_dx + ray.dir * t_dxy[..., 0:1]
            + ray_diff.dir_dx * t[..., None])
    dpdy = (ray_diff.org_dy + ray.dir * t_dxy[..., 1:2]
            + ray_diff.dir_dy * t[..., None])

    # Shading normal: interpolate when present, else geometric
    nn = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2
    dnn_dx = ((-u_dxy[..., 0:1] - v_dxy[..., 0:1]) * n0
              + u_dxy[..., 0:1] * n1 + v_dxy[..., 0:1] * n2)
    dnn_dy = ((-u_dxy[..., 1:2] - v_dxy[..., 1:2]) * n0
              + u_dxy[..., 1:2] * n1 + v_dxy[..., 1:2] * n2)
    nn_len_sq = vm.length_squared(nn)
    nn_ok = has_normals & (nn_len_sq > 0.0)
    nn_len_sq_safe = torch.where(nn_ok, nn_len_sq, torch.ones_like(nn_len_sq))
    nn_len = torch.sqrt(nn_len_sq_safe)
    denom = (nn_len_sq_safe * nn_len)[..., None]
    nn_safe = torch.where(nn_ok[..., None], nn, geom_normal)
    zero3 = torch.zeros_like(nn)
    dn_dx = torch.where(
        nn_ok[..., None],
        (nn_len_sq_safe[..., None] * dnn_dx
         - vm.vdot(nn_safe, dnn_dx) * nn_safe) / denom,
        zero3,
    )
    dn_dy = torch.where(
        nn_ok[..., None],
        (nn_len_sq_safe[..., None] * dnn_dy
         - vm.vdot(nn_safe, dnn_dy) * nn_safe) / denom,
        zero3,
    )
    shading_normal = torch.where(nn_ok[..., None], vm.normalize(nn_safe),
                                 geom_normal)
    # Flip geometric normal to the shading-normal side (src/shape.h:342-345)
    flip = nn_ok & (vm.dot(geom_normal, shading_normal) < 0.0)
    geom_normal = torch.where(flip[..., None], -geom_normal, geom_normal)

    # Shading frame: orthonormalize dpdu against the shading normal
    frame_x = vm.normalize(dpdu)
    frame_y = vm.cross(shading_normal, frame_x)
    fy_ok = vm.length_squared(frame_y) > 0.0
    frame_y_n = vm.normalize(frame_y)
    frame_x_n = vm.cross(frame_y_n, shading_normal)
    cs2_x, cs2_y = vm.coordinate_system(shading_normal)
    frame_x = torch.where(fy_ok[..., None], frame_x_n, cs2_x)
    frame_y = torch.where(fy_ok[..., None], frame_y_n, cs2_y)

    new_ray_diff = RayDifferential(
        org_dx=dpdx, org_dy=dpdy, dir_dx=ray_diff.dir_dx,
        dir_dy=ray_diff.dir_dy,
    )
    color = w[..., None] * c0 + u[..., None] * c1 + v[..., None] * c2
    sp = SurfacePoint(
        position=hit_pos,
        geom_normal=geom_normal,
        frame_x=frame_x,
        frame_y=frame_y,
        frame_n=shading_normal,
        dpdu=dpdu,
        uv=uv,
        du_dxy=du_dxy,
        dv_dxy=dv_dxy,
        dn_dx=dn_dx,
        dn_dy=dn_dy,
        color=color,
        barycentric=torch.stack([u, v], dim=-1),
    )
    return sp, new_ray_diff


def sample_tri_point(v0, v1, v2, sample):
    """Uniform point on triangles; returns (position, normal, barycentric).

    Parameterization matches the reference: a=sqrt(u0), b1=1-a, b2=a*u1.
    """
    a = torch.sqrt(vm.clip(sample[..., 0], 0.0, 1.0))
    b1 = 1.0 - a
    b2 = a * sample[..., 1]
    e1 = v1 - v0
    e2 = v2 - v0
    n = vm.normalize(vm.cross(e1, e2))
    pos = v0 + e1 * b1[..., None] + e2 * b2[..., None]
    return pos, n, torch.stack([b1, b2], dim=-1)


def tri_areas(vertices, indices):
    """Per-triangle areas (reference: src/shape.h:157-165)."""
    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    return 0.5 * vm.length(vm.cross(v1 - v0, v2 - v0))
