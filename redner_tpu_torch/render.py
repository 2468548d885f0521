"""The differentiable wavefront path tracer, forward path (port of
redner_tpu/render.py; reference src/pathtracer.cpp:177-945).

Every lane of a fixed (num_lanes,) axis is one pixel-sample; activity is a
boolean mask.  Discrete quantities (hit ids, occlusion, RNG, CDF picks) are
detached, so torch autograd of `render_image` gives the continuous
(AD-only) gradients that `jax.grad(redner_tpu.render_image)` gives.  The
code runs eagerly: the sample loop and bounce loop are Python loops; on a
card, render_image (with or without autograd) and render_grad.render
replay them as cached CUDA graphs (graphs.py).

The edge-sampling hooks are here too: `trace_radiance` and `render_sample`
trace externally supplied rays (the edge passes' offset pairs) and, given a
radiance adjoint, emit the secondary-edge surrogate at every bounce
(`_secondary_edge_term`); `_render_image_impl(secondary_d_radiance=...)`
runs that fused pass over the sample loop for render_grad.render.

`render_sample` fills every AOV channel at the primary hit
(`_accumulate_primary`) and runs the bounce loop only when the radiance
channel is asked for.

Remat (`RenderOptions.remat`) wraps each pass of the sample loop in
torch.utils.checkpoint when grad is enabled.  `isect_replay_max_mb` is
accepted and changes nothing: the backward re-runs its ray queries (see
render_grad).

`split_shadow_sweep=False` is accepted and changes nothing: shadow rays
go through the any-hit query either way.  redner_tpu's single closest-hit
sweep over shadow and continuation rays gives the same hits, and on an H100
it made no workload faster (PERF.md).

`pixel_sharding` (parallel.sharding.pixel_sharding) splits the sample
loop's pixel lanes over the ranks of a process group; see
_render_image_impl and core/shardutil.py.

With tracing on (timing.set_tracing) the body records its device phases
(timing.phase): `fwd` around a forward, `camera` (ray generation),
`shade.surface` (the hit's surface point and material: the vertex, corner
and material gathers), and in the bounce loop, with its index,
`shade.bsdf` (the BSDF sample, then its contribution), `shade.nee` (the
light sample, then its contribution), `shade.surface` of the hit and
`edge.secondary`; accel's ray queries are `isect.*` phases.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import redner_tpu_torch.sampler as sampler_mod
from redner_tpu_torch import accel, timing
from redner_tpu_torch.camera import Camera, sample_primary_rays
from redner_tpu_torch.channels import ChannelInfo, Channels
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.core.shardutil import (gather_lanes, lane_block,
                                             reduce_leaf_grads, shard_count,
                                             shard_rank)
from redner_tpu_torch.core.types import (Intersection, Ray, RayDifferential,
                                         SurfacePoint)
from redner_tpu_torch.edge import build_edge_table, secondary_edge_surrogate
from redner_tpu_torch.envmap import envmap_eval, envmap_pdf, envmap_sample
from redner_tpu_torch.geometry import build_surface_point, sample_tri_point
from redner_tpu_torch.material import (LocalMaterial, bsdf, bsdf_pdf,
                                       bsdf_sample, perturb_shading_frame)
from redner_tpu_torch.ops.gather_cuda import gather_rows
from redner_tpu_torch.sampler import SamplerType
from redner_tpu_torch.scene import (FlatScene, Scene, _fetch_material_stack,
                                    face_corner_attribs, face_rows,
                                    face_vertices, fetch_local_material,
                                    flatten_scene, gather_face_vertices,
                                    scene_leaves, scene_tensors,
                                    scene_with_leaves)


class RenderOptions:
    """Static render configuration (reference RenderOptions,
    src/redner.cpp:207-216); same fields as redner_tpu.RenderOptions."""

    def __init__(
        self,
        num_samples: int = 4,
        max_bounces: int = 1,
        channels: Sequence[Channels] = (Channels.radiance,),
        sampler_type: SamplerType = SamplerType.independent,
        sample_pixel_center: bool = False,
        use_primary_edge_sampling: bool = True,
        use_secondary_edge_sampling: bool = True,
        num_edge_samples: Optional[int] = None,
        max_generic_texture_dimension: int = 16,
        remat: bool = False,
        split_shadow_sweep: bool = True,
        isect_replay_max_mb: float = 0.0,
    ):
        # (forward, backward) sample counts: an int means both passes.
        if isinstance(num_samples, (tuple, list)):
            self.num_samples = int(num_samples[0])
            self.num_samples_backward = int(num_samples[1])
        else:
            self.num_samples = int(num_samples)
            self.num_samples_backward = int(num_samples)
        self.max_bounces = int(max_bounces)
        self.channel_info = ChannelInfo(channels, max_generic_texture_dimension)
        self.sampler_type = sampler_type
        self.sample_pixel_center = bool(sample_pixel_center)
        self.use_primary_edge_sampling = bool(use_primary_edge_sampling)
        self.use_secondary_edge_sampling = bool(use_secondary_edge_sampling)
        self.num_edge_samples = num_edge_samples
        self.remat = bool(remat)
        # Shadow rays through the any-hit query, continuation rays through
        # the closest-hit one, whatever the value (see the module doc).
        self.split_shadow_sweep = bool(split_shadow_sweep)
        self.isect_replay_max_mb = float(isect_replay_max_mb)
        self._frozen = True

    def __setattr__(self, name, value):
        if getattr(self, "_frozen", False):
            raise AttributeError(
                "RenderOptions is frozen after construction; build a new one")
        object.__setattr__(self, name, value)

    def _key(self):
        """Every field by value (the channel layout by its channels and
        generic width): equal keys render the same program."""
        return tuple(sorted(
            (k, (v.channels, v.max_generic_texture_dimension)
             if isinstance(v, ChannelInfo) else v)
            for k, v in vars(self).items() if k != "_frozen"))

    def _copy_with(self, **overrides):
        """A new frozen RenderOptions with some fields replaced."""
        new = copy.copy(self)
        for k, v in overrides.items():
            if not hasattr(new, k):
                raise AttributeError(f"RenderOptions has no field {k!r}")
            object.__setattr__(new, k, v)
        return new


def _surface_point_at(fs: FlatScene, isect: Intersection, ray: Ray,
                      ray_diff: RayDifferential):
    """Differentiable surface point from a (non-diff) hit record.

    Missed lanes re-derive a point on a clamped triangle whose values can
    be huge; they are replaced at the source by a benign on-origin point
    with unit frames so no NaN reaches a gradient through 0*inf."""
    row = face_rows(fs, isect.tri_id)
    v0, v1, v2 = face_vertices(row)
    (uv0, uv1, uv2, n0, n1, n2, has_n, c0, c1, c2) = face_corner_attribs(row)
    sp, rd = build_surface_point(
        v0, v1, v2, uv0, uv1, uv2, n0, n1, n2, has_n, c0, c1, c2, ray, ray_diff
    )
    m3 = isect.valid[..., None]
    kw = dict(dtype=sp.position.dtype, device=sp.position.device)
    ex = const((1.0, 0.0, 0.0), **kw)
    ey = const((0.0, 1.0, 0.0), **kw)
    ez = const((0.0, 0.0, 1.0), **kw)
    z2 = torch.zeros((2,), **kw)
    z3 = torch.zeros((3,), **kw)
    sp = SurfacePoint(
        position=torch.where(m3, sp.position, ray.org),
        geom_normal=torch.where(m3, sp.geom_normal, ez),
        frame_x=torch.where(m3, sp.frame_x, ex),
        frame_y=torch.where(m3, sp.frame_y, ey),
        frame_n=torch.where(m3, sp.frame_n, ez),
        dpdu=torch.where(m3, sp.dpdu, ex),
        uv=torch.where(m3, sp.uv, z2),
        du_dxy=torch.where(m3, sp.du_dxy, z2),
        dv_dxy=torch.where(m3, sp.dv_dxy, z2),
        dn_dx=torch.where(m3, sp.dn_dx, z3),
        dn_dy=torch.where(m3, sp.dn_dy, z3),
        color=torch.where(m3, sp.color, z3),
        barycentric=torch.where(m3, sp.barycentric, z2),
    )
    rd = RayDifferential(
        org_dx=torch.where(m3, rd.org_dx, z3),
        org_dy=torch.where(m3, rd.org_dy, z3),
        dir_dx=torch.where(m3, rd.dir_dx, z3),
        dir_dy=torch.where(m3, rd.dir_dy, z3),
    )
    return sp, rd


def _shade_surface(fs: FlatScene, isect: Intersection, ray: Ray,
                   ray_diff: RayDifferential):
    """The `shade.surface` phase of a camera ray's hit: its surface point
    (_surface_point_at) and material (fetch_local_material) -> (sp, rd,
    lm)."""
    with timing.phase("shade.surface", fs.device) as ph:
        ph.enter(fs, ray, ray_diff)
        sp, rd = _surface_point_at(fs, isect, ray, ray_diff)
        mid = fs.face_material_id[torch.clamp(isect.tri_id, 0,
                                              fs.num_triangles - 1)]
        return ph.exit((sp, rd, fetch_local_material(fs, sp, mid)))


def _face_emission(fs: FlatScene, tri_id, wi_dot_n, camera_ray: bool = True):
    """Area-light emission toward wi for hit faces; zeros for non-emitters
    (src/primary_contribution.cpp:13-23).  `directly_visible` only hides
    lights from camera rays."""
    tid = torch.clamp(tri_id, 0, fs.num_triangles - 1)
    lid = fs.face_light_id[tid]
    is_light = lid >= 0
    if fs.num_area_lights == 0:
        return torch.zeros(tri_id.shape + (3,), dtype=fs.vertices.dtype,
                           device=fs.device), is_light
    lid_c = torch.clamp(lid, 0, fs.num_area_lights - 1)
    intensity = gather_rows(fs.light_intensity, lid_c)
    two_sided = fs.light_two_sided[lid_c]
    ok = is_light & (two_sided | (wi_dot_n > 0))
    if camera_ray:
        ok = ok & fs.light_directly_visible[lid_c]
    return torch.where(ok[..., None], intensity,
                       torch.zeros_like(intensity)), is_light


def _accumulate_primary(fs: FlatScene, ci: ChannelInfo, ray: Ray,
                        isect: Intersection, sp: SurfacePoint,
                        lm: LocalMaterial):
    """Every G-buffer channel at the primary hit
    (src/primary_contribution.cpp:6-437) -> (n, C).  Missed lanes write
    zeros, and so do the radiance columns, which `trace_radiance` fills.
    """
    n = isect.tri_id.shape[0]
    dtype, dev = sp.position.dtype, sp.position.device
    valid = isect.valid
    vmask = valid[..., None]

    def masked(x):
        if x.dim() == 1:
            return torch.where(valid, x, torch.zeros_like(x))[:, None]
        return torch.where(vmask, x, torch.zeros_like(x))

    def mid():
        return fs.face_material_id[
            torch.clamp(isect.tri_id, 0, fs.num_triangles - 1)]

    cols = []
    for ch in ci.channels:
        if ch == Channels.radiance:
            cols.append(torch.zeros((n, 3), dtype=dtype, device=dev))
        elif ch == Channels.alpha:
            cols.append(masked(torch.ones((n,), dtype=dtype, device=dev)))
        elif ch == Channels.depth:
            # A missed lane's point is the ray origin, and the derivative
            # of a zero length is NaN even under the mask: give those
            # lanes a unit offset (the reference's depth channel returns a
            # NaN camera-position gradient wherever a camera ray misses).
            off = torch.where(vmask, ray.org - sp.position,
                              torch.ones_like(sp.position))
            cols.append(masked(vm.length(off)))
        elif ch == Channels.position:
            cols.append(masked(sp.position))
        elif ch == Channels.geometry_normal:
            cols.append(masked(sp.geom_normal))
        elif ch == Channels.shading_normal:
            cols.append(masked(perturb_shading_frame(lm, sp)[2]))
        elif ch == Channels.uv:
            cols.append(masked(sp.uv))
        elif ch == Channels.barycentric_coordinates:
            cols.append(masked(sp.barycentric))
        elif ch == Channels.diffuse_reflectance:
            cols.append(masked(lm.diffuse))
        elif ch == Channels.specular_reflectance:
            cols.append(masked(lm.specular))
        elif ch == Channels.roughness:
            cols.append(masked(lm.roughness))
        elif ch == Channels.generic_texture:
            cols.append(masked(_fetch_material_stack(
                fs.mat_generic, sp.uv, sp.du_dxy, sp.dv_dxy, mid(),
                ci.max_generic_texture_dimension)))
        elif ch == Channels.vertex_color:
            cols.append(masked(sp.color))
        elif ch == Channels.shape_id:
            cols.append(masked(isect.shape_id.to(dtype)))
        elif ch == Channels.triangle_id:
            cols.append(masked(isect.tri_id.to(dtype)))
        elif ch == Channels.material_id:
            cols.append(masked(mid().to(dtype)))
    return torch.cat(cols, dim=-1)


def _sample_light_point(fs: FlatScene, sp_pos, light_uniforms):
    """NEE light/triangle/point selection (src/scene.cpp:692-759).

    light_uniforms: (n, 4) = (light_sel, tri_sel, uv0, uv1).
    Returns a dict with the shadow Ray, the light point data and is_env.
    A lane that picked the envmap (the last light slot) gets an envmap
    sample and a shadow ray to infinity in the same batch."""
    n = sp_pos.shape[0]
    kw = dict(dtype=sp_pos.dtype, device=sp_pos.device)
    light_id = torch.clamp(
        vm.searchsorted_right(fs.light_cdf, light_uniforms[:, 0]) - 1,
        0, fs.num_lights - 1,
    )
    is_env = (light_id == fs.num_lights - 1) if fs.has_envmap \
        else torch.zeros((n,), dtype=torch.bool, device=sp_pos.device)
    tmin = torch.full((n,), 1e-3, **kw)
    out = {"is_env": is_env}
    if fs.num_area_lights > 0:
        lidx = torch.clamp(light_id, 0, fs.num_area_lights - 1)
        row_cdf = fs.light_tri_cdf[lidx]  # (n, Tmax)
        tri_ofs = torch.clamp(
            vm.searchsorted_right(row_cdf, light_uniforms[:, 1]) - 1,
            0, row_cdf.shape[-1] - 1,
        )
        face = fs.light_tri_face[lidx, tri_ofs]
        v0, v1, v2 = gather_face_vertices(fs, face)
        lpos, lnormal, _ = sample_tri_point(v0, v1, v2,
                                            light_uniforms[:, 2:4])
        # The light-sample chain is frozen w.r.t. light geometry: AD
        # carries only the smooth integrand terms; the secondary-edge pass
        # supplies the boundary term (redner_tpu/render.py:369-379).
        lpos = lpos.detach()
        lnormal = lnormal.detach()
        ldir = lpos - sp_pos
        out.update(area_light_id=lidx, light_pos=lpos, light_normal=lnormal)
        shadow_ray = Ray(org=sp_pos, dir=vm.normalize(ldir), tmin=tmin,
                         tmax=(1.0 - 1e-3) * vm.length(ldir).detach())
    if fs.has_envmap:
        env_dir = envmap_sample(fs.envmap, light_uniforms[:, 2:4])
        out["env_dir"] = env_dir
        inf = torch.full((n,), float("inf"), **kw)
        if fs.num_area_lights > 0:
            m = is_env[..., None]
            shadow_ray = Ray(org=sp_pos,
                             dir=torch.where(m, env_dir, shadow_ray.dir),
                             tmin=tmin,
                             tmax=torch.where(is_env, inf, shadow_ray.tmax))
        else:
            shadow_ray = Ray(org=sp_pos, dir=env_dir, tmin=tmin, tmax=inf)
    out["shadow_ray"] = shadow_ray
    return out


def _nee_contribution(fs, lm, sp, wi, min_rough, ls, blocked):
    """NEE contribution with MIS (src/path_contribution.cpp:28-70)."""
    nee = torch.zeros_like(wi)
    if fs.num_area_lights > 0:
        lidx = ls["area_light_id"]
        lpos = ls["light_pos"]
        lnormal = ls["light_normal"]
        dirv = lpos - sp.position
        dist_sq = vm.length_squared(dirv)
        ok = dist_sq > 1e-20
        wo = vm.normalize(dirv)
        intensity = gather_rows(fs.light_intensity, lidx)
        two_sided = fs.light_two_sided[lidx]
        front = two_sided | (vm.dot(-wo, lnormal) > 0)
        bsdf_val = bsdf(lm, sp, wi, wo, min_rough)
        geom_term = vm.safe_div(torch.abs(vm.dot(wo, lnormal)), dist_sq)
        pdf_nee = vm.safe_div(fs.light_pmf[lidx], fs.light_areas[lidx])
        pdf_b = bsdf_pdf(lm, sp, wi, wo, min_rough) * geom_term
        mis = 1.0 / (1.0 + vm.square(vm.safe_div(pdf_b, pdf_nee)))
        contrib = (
            (mis * geom_term
             * vm.safe_div(torch.ones_like(pdf_nee), pdf_nee))[..., None]
            * bsdf_val
            * intensity
        )
        ok = ok & front & (pdf_nee > 0) & ~ls["is_env"] & ~blocked
        nee = nee + torch.where(ok[..., None], contrib,
                                torch.zeros_like(contrib))
    if fs.has_envmap:
        wo = ls["env_dir"]
        pdf_nee = envmap_pdf(fs.envmap, wo) * fs.light_pmf[fs.num_lights - 1]
        ok = (pdf_nee > 0) & ls["is_env"] & ~blocked
        bsdf_val = bsdf(lm, sp, wi, wo, min_rough)
        light_contrib = envmap_eval(
            fs.envmap, wo, RayDifferential.zero(wo.shape[:-1], wo.dtype,
                                                wo.device))
        pdf_b = bsdf_pdf(lm, sp, wi, wo, min_rough)
        mis = 1.0 / (1.0 + vm.square(vm.safe_div(pdf_b, pdf_nee)))
        contrib = (mis * vm.safe_div(torch.ones_like(pdf_nee),
                                     pdf_nee))[..., None] * (
            bsdf_val * light_contrib)
        nee = nee + torch.where(ok[..., None], contrib,
                                torch.zeros_like(contrib))
    return nee


def _face_emission_nee(fs, isect, wo, sp_light):
    """Emission of a BSDF-sampled hit toward -wo, with two-sided test
    (src/path_contribution.cpp:80-90)."""
    tid = torch.clamp(isect.tri_id, 0, fs.num_triangles - 1)
    lid = fs.face_light_id[tid]
    is_light = isect.valid & (lid >= 0)
    if fs.num_area_lights == 0:
        return torch.zeros_like(wo), is_light
    lidc = torch.clamp(lid, 0, fs.num_area_lights - 1)
    intensity = gather_rows(fs.light_intensity, lidc)
    two_sided = fs.light_two_sided[lidc]
    front = two_sided | (vm.dot(-wo, sp_light.frame_n) > 0)
    ok = is_light & front
    return torch.where(ok[..., None], intensity,
                       torch.zeros_like(intensity)), ok


def _scatter_contribution(fs, lm, sp, wi, min_rough, bsdf_ray, bsdf_isect,
                          bsdf_sp):
    """BSDF-sampling contribution with MIS + throughput update factor
    (src/path_contribution.cpp:71-127).  Returns (scatter_contrib (n,3),
    scatter_bsdf (n,3) = bsdf/pdf for the throughput update).  A ray that
    escapes picks up the envmap."""
    hit = bsdf_isect.valid
    dirv = bsdf_sp.position - sp.position
    dist_sq = vm.length_squared(dirv)
    # Missed rays re-derive a point that can coincide with the shading
    # plane; normalize(~0) has NaN derivatives that leak through where.
    dir_ok = hit & (dist_sq > 1e-20)
    z_axis = const((0.0, 0.0, 1.0), dirv.dtype, dirv.device)
    safe_dirv = torch.where(dir_ok[..., None], dirv, z_axis)
    wo_hit = vm.normalize(safe_dirv)
    pdf_b_hit = bsdf_pdf(lm, sp, wi, wo_hit, min_rough)
    ok_hit = dir_ok & (pdf_b_hit > 1e-20)
    bsdf_val_hit = bsdf(lm, sp, wi, wo_hit, min_rough)
    emission, is_light = _face_emission_nee(fs, bsdf_isect, wo_hit, bsdf_sp)
    inv_pdf_b = vm.safe_div(torch.ones_like(pdf_b_hit), pdf_b_hit)
    scatter = torch.zeros_like(bsdf_val_hit)
    if fs.num_area_lights > 0:
        tid = torch.clamp(bsdf_isect.tri_id, 0, fs.num_triangles - 1)
        lid = torch.clamp(fs.face_light_id[tid], 0, fs.num_area_lights - 1)
        geom_term = vm.safe_div(
            torch.abs(vm.dot(wo_hit, bsdf_sp.geom_normal)), dist_sq)
        pdf_nee = vm.safe_div(
            vm.safe_div(fs.light_pmf[lid], fs.light_areas[lid]), geom_term
        )
        mis = 1.0 / (1.0 + vm.square(vm.safe_div(pdf_nee, pdf_b_hit)))
        lcontrib = (mis * inv_pdf_b)[..., None] * (bsdf_val_hit * emission)
        scatter = scatter + torch.where(
            (ok_hit & is_light)[..., None], lcontrib, torch.zeros_like(lcontrib)
        )
    sb = bsdf_val_hit * inv_pdf_b[..., None]
    scatter_bsdf = torch.where(ok_hit[..., None], sb, torch.zeros_like(sb))

    if fs.has_envmap:
        # The escaped ray hits the environment (the path ends).
        wo_env = bsdf_ray.dir
        pdf_b_env = bsdf_pdf(lm, sp, wi, wo_env, min_rough)
        ok_env = (~hit) & (vm.length_squared(wo_env) > 0) & (pdf_b_env > 1e-20)
        bsdf_val_env = bsdf(lm, sp, wi, wo_env, min_rough)
        # Sanitize masked lanes before the spherical-coordinate math: the
        # atan2/acos of a zero direction has NaN derivatives that leak
        # through torch.where (double-where guard).
        safe_wo_env = torch.where(ok_env[..., None], wo_env, z_axis)
        light_contrib = envmap_eval(
            fs.envmap, safe_wo_env,
            RayDifferential.zero(wo_env.shape[:-1], wo_env.dtype,
                                 wo_env.device))
        pdf_nee = envmap_pdf(fs.envmap, safe_wo_env) \
            * fs.light_pmf[fs.num_lights - 1]
        mis = 1.0 / (1.0 + vm.square(vm.safe_div(pdf_nee, pdf_b_env)))
        contrib = (mis * vm.safe_div(torch.ones_like(pdf_b_env),
                                     pdf_b_env))[..., None] * (
            bsdf_val_env * light_contrib)
        scatter = scatter + torch.where(ok_env[..., None], contrib,
                                        torch.zeros_like(contrib))
    return scatter, scatter_bsdf


def trace_radiance(
    fs: FlatScene,
    options: RenderOptions,
    seed,
    lane_ids,
    sample_id,
    ray: Ray,
    ray_diff: RayDifferential,
    dim_start: int = sampler_mod.CAMERA_DIMS,
    include_primary_emission: bool = True,
    camera_ray: bool = True,
    primary_isect: Optional[Intersection] = None,
    return_emission: bool = False,
    coherent: bool = False,
    secondary_d_pixel=None,
    secondary_edge_table=None,
    precise_primary: bool = False,
    engine=None,
    secondary_lane_sharding=None,
):
    """Full-path radiance estimate for arbitrary primary rays -> (n, 3)
    (redner_tpu/render.py:572-797, without the replay branch).

    lane_ids keys the RNG (pixel ids for camera paths, edge-sample ids for
    edge paths); dim_start is the first sample dimension drawn.
    coherent: rays are tile-coherent (swizzled pixels), so the ray queries
    skip their Morton sort.  engine: see accel.intersect.  precise_primary
    is accepted and ignored (every query is exact f32).

    return_emission: also return the first-hit emission term alone, as
    (radiance, emission); the secondary-edge pass weights it apart.
    secondary_d_pixel: (n, 3) per-lane radiance adjoint.  When given, every
    bounce also emits the secondary-edge surrogate from this loop's
    intersections, light samples and materials (src/pathtracer.cpp:431-707),
    and the return value is (radiance, surrogate scalar);
    secondary_lane_sharding is the pixel sharding the lanes belong to (the
    surrogate's firefly clamp sums over all ranks' lanes).
    """
    n = ray.org.shape[0]
    kw = dict(dtype=ray.org.dtype, device=ray.org.device)
    radiance = torch.zeros((n, 3), **kw)
    primary_emission = torch.zeros((n, 3), **kw)
    surrogate = torch.zeros((), **kw)

    isect = (accel.intersect(fs, ray, presorted=coherent, engine=engine)
             if primary_isect is None else primary_isect)
    sp, ray_diff, lm = _shade_surface(fs, isect, ray, ray_diff)
    dev = fs.device

    if include_primary_emission:
        emission, _ = _face_emission(
            fs, isect.tri_id, vm.dot(-ray.dir, sp.frame_n), camera_ray=camera_ray
        )
        primary_emission = torch.where(isect.valid[..., None], emission,
                                       torch.zeros_like(emission))
        if fs.has_envmap and (fs.envmap.directly_visible or not camera_ray):
            miss = (torch.sum(ray.dir * ray.dir, dim=-1) > 0) & ~isect.valid
            safe_dir = torch.where(
                miss[..., None], ray.dir,
                const((0.0, 0.0, 1.0), **kw))
            env = envmap_eval(fs.envmap, safe_dir, ray_diff)
            primary_emission = torch.where(miss[..., None], env,
                                           primary_emission)
        radiance = radiance + primary_emission

    dim = sampler_mod.DimAllocator()
    dim.dim = dim_start
    active = isect.valid
    throughput = torch.ones((n, 3), **kw)
    min_rough = torch.zeros((n,), **kw)
    incoming_ray = ray
    incoming_diff = ray_diff
    for bounce in range(options.max_bounces):
        light_dim = dim.next(sampler_mod.LIGHT_DIMS)
        bsdf_dim = dim.next(sampler_mod.BSDF_DIMS)
        wi = -incoming_ray.dir

        with timing.phase("shade.bsdf", dev, bounce=bounce) as ph:
            ph.enter(lm, sp, wi, min_rough, incoming_diff)
            bsdf_u = sampler_mod.draw(
                options.sampler_type, seed, lane_ids, sample_id, bsdf_dim, 3
            )
            wo, wo_diff, next_min_rough = ph.exit(bsdf_sample(
                lm, sp, wi, bsdf_u[:, 0], bsdf_u[:, 1:3], min_rough,
                incoming_diff))
        bsdf_ray = Ray(
            org=sp.position,
            dir=torch.where(active[..., None], wo, torch.zeros_like(wo)),
            tmin=torch.full((n,), 1e-3, **kw),
            tmax=torch.full((n,), float("inf"), **kw),
        )
        # Every sweep below starts ON scene geometry; the port's queries are
        # exact f32 everywhere, so `precise` has nothing to select.
        nee_dir = None
        if fs.num_lights > 0:
            with timing.phase("shade.nee", dev, bounce=bounce) as ph:
                ph.enter(fs, sp)
                light_u = sampler_mod.draw(
                    options.sampler_type, seed, lane_ids, sample_id,
                    light_dim, 4)
                ls = ph.exit(_sample_light_point(fs, sp.position, light_u))
            sray = ls["shadow_ray"]
            blocked = accel.occluded(fs, sray, presorted=coherent,
                                     engine=engine)
            bsdf_isect = accel.intersect(fs, bsdf_ray, presorted=coherent,
                                         engine=engine)
            with timing.phase("shade.nee", dev, bounce=bounce) as ph:
                ph.enter(fs, lm, sp, wi, min_rough, ls)
                nee = ph.exit(_nee_contribution(fs, lm, sp, wi, min_rough,
                                                ls, blocked))
            nee_dir = sray.dir
        else:
            nee = torch.zeros((n, 3), **kw)
            bsdf_isect = accel.intersect(fs, bsdf_ray, presorted=coherent,
                                         engine=engine)
        with timing.phase("shade.surface", dev, bounce=bounce) as ph:
            ph.enter(fs, bsdf_ray, wo_diff)
            bsdf_sp, bsdf_diff = ph.exit(_surface_point_at(
                fs, bsdf_isect, bsdf_ray, wo_diff))

        with timing.phase("shade.bsdf", dev, bounce=bounce) as ph:
            ph.enter(fs, lm, sp, wi, min_rough, bsdf_ray, bsdf_sp)
            scatter, scatter_bsdf = ph.exit(_scatter_contribution(
                fs, lm, sp, wi, min_rough, bsdf_ray, bsdf_isect, bsdf_sp))
        contrib = throughput * (nee + scatter)
        radiance = radiance + torch.where(active[..., None], contrib,
                                          torch.zeros_like(contrib))

        if secondary_d_pixel is not None:
            with timing.phase("edge.secondary", dev, bounce=bounce):
                surrogate = surrogate + _secondary_edge_term(
                    fs, options, seed, lane_ids, sample_id, bounce,
                    sp, lm, wi, min_rough, active, throughput,
                    secondary_d_pixel, nee_dir, secondary_edge_table,
                    engine=engine, lane_sharding=secondary_lane_sharding,
                )

        tp = throughput * scatter_bsdf
        throughput = torch.where(active[..., None], tp, torch.zeros_like(tp))
        active = active & bsdf_isect.valid & (
            torch.amax(torch.abs(throughput), dim=-1) > 0
        )
        if bounce + 1 >= options.max_bounces:
            break
        sp = bsdf_sp
        incoming_ray = bsdf_ray
        incoming_diff = bsdf_diff
        min_rough = next_min_rough
        with timing.phase("shade.surface", dev, bounce=bounce) as ph:
            ph.enter(fs, sp)
            mid = fs.face_material_id[
                torch.clamp(bsdf_isect.tri_id, 0, fs.num_triangles - 1)
            ]
            lm = ph.exit(fetch_local_material(fs, sp, mid))
    if secondary_d_pixel is not None:
        return radiance, surrogate
    if return_emission:
        return radiance, primary_emission
    return radiance


# Cap on the mirror-lobe RIS kernel's relative amplitude (see
# _secondary_edge_term).
SPEC_KERNEL_CAP = 64.0


def _secondary_edge_term(fs, options, seed, lane_ids, sample_id, bounce,
                         sp, lm, wi, min_rough, active, throughput,
                         d_pixel, nee_dir, edge_table=None, engine=None,
                         lane_sharding=None):
    """One bounce's secondary-edge surrogate, fed from the live wavefront
    state (redner_tpu/render.py:807-880), on this rank's lanes."""

    def bsdf_eval(wo):
        return bsdf(lm, sp, wi, wo, min_rough)

    def bsdf_pdf_eval(wo):
        return bsdf_pdf(lm, sp, wi, wo, min_rough)

    with torch.no_grad():
        # Glossy importance: a mirror-reflection lobe of the true width
        # (alpha) and peak ratio steers the RIS kernel (the role of the
        # reference's LTC component selection, src/edge.cpp:1403-1448).
        _, _, pn = perturb_shading_frame(lm, sp)
        refl = 2.0 * vm.vdot(wi, pn) * pn - wi
        alpha = vm.clip(vm.maximum(lm.roughness, 1e-6), 0.03, 1.0)
        lum = const((0.2126, 0.7152, 0.0722), alpha.dtype, alpha.device)
        l_spec = torch.sum(lm.specular * lum, dim=-1)
        l_diff = torch.sum(lm.diffuse * lum, dim=-1)
        spec_weight = vm.minimum(
            l_spec / (alpha * alpha * vm.maximum(l_diff, 1e-2)),
            SPEC_KERNEL_CAP)
        # Paths already diffuse-ized by a rough bounce skip secondary edge
        # sampling (src/edge.cpp:1396-1401).
        sec_active = active & (min_rough <= 1e-2)
        d_pix = throughput.detach() * d_pixel
        nee_dir = None if nee_dir is None else nee_dir.detach()
    return secondary_edge_surrogate(
        fs, options, seed, sample_id,
        sp.position, wi, bsdf_eval, trace_radiance,
        d_pix, sec_active, nee_dir=nee_dir,
        dim_base=100 + 32 * bounce,
        bsdf_pdf_fn=bsdf_pdf_eval,
        specular_dir=refl,
        specular_sigma=alpha,
        specular_weight=spec_weight,
        lane_ids=lane_ids,
        edge_table=edge_table,
        shading_normal=pn,
        engine=engine,
        lane_sharding=lane_sharding,
    )


SWIZZLE_BLOCK = (16, 32)  # (rows, cols) of one screen block of lanes

# Target lane count per pass of the image loop: samples are batched into the
# lane axis until roughly this many lanes per pass.
SAMPLES_LANE_TARGET = 1 << 16


def swizzle_order(vh: int, vw: int):
    """Static pixel permutation grouping 16x32 screen blocks contiguously, so
    ray tiles have tight frusta and the chunk culling prunes.  Returns
    (order, inverse) as numpy int64 (order[k] = flat pixel of lane k).
    _swizzle_tensors keeps them on a device."""
    bh, bw = SWIZZLE_BLOCK
    y, x = np.mgrid[0:vh, 0:vw]
    key = (
        ((y // bh) * ((vw + bw - 1) // bw) + (x // bw)).astype(np.int64)
        * (bh * bw)
        + (y % bh) * bw
        + (x % bw)
    )
    order = np.argsort(key.ravel(), kind="stable")
    inverse = np.argsort(order, kind="stable")
    return order, inverse


def _swizzle_tensors(vh: int, vw: int, device):
    """swizzle_order's (order, inverse), kept per (vh, vw, device)."""
    return tuple(
        const(lambda i=i: swizzle_order(vh, vw)[i], torch.int64, device,
              key=("swizzle_order", vh, vw, i))
        for i in (0, 1))


def render_sample(
    fs: FlatScene,
    camera: Camera,
    options: RenderOptions,
    seed,
    sample_id,
    jitter=None,
    primary_rays=None,
    pixel_order=None,
    secondary_d_pixel=None,
    secondary_edge_table=None,
    precise_primary: bool = False,
    rays_coherent: bool = False,
    engine=None,
    secondary_lane_sharding=None,
):
    """Trace one sample per lane; returns the (num_lanes, C) contribution
    (unweighted; the caller averages), lane k = pixel pixel_order[k]
    (identity when None).  The RNG is keyed by the true pixel id.  Every
    AOV channel is filled at the primary hit; the bounce loop runs only
    for the radiance channel.

    jitter: (n, 2) sub-pixel offsets in place of the drawn ones (the screen
    gradient differentiates the render w.r.t. them).
    primary_rays: (Ray, RayDifferential) supplied by an edge pass in place
    of camera rays; the lanes then key the RNG directly (pixel_order holds
    the keys).  rays_coherent: the caller guarantees such rays are
    tile-coherent (the primary-edge samples are Morton-sorted), so every
    ray query skips its sort.  secondary_d_pixel / secondary_edge_table go
    to trace_radiance's fused secondary-edge pass, with the pixel sharding
    of the lanes (secondary_lane_sharding); the return value is then
    (contribution, surrogate scalar).  precise_primary is ignored."""
    ci = options.channel_info
    top, left, bottom, right = camera.viewport_or_full
    dev = fs.device
    if pixel_order is None:
        n = (primary_rays[0].org.shape[0] if primary_rays is not None
             else (right - left) * (bottom - top))
        pixel_ids = torch.arange(n, device=dev)
    else:
        pixel_ids = torch.as_tensor(pixel_order, dtype=torch.int64, device=dev)
    n = pixel_ids.shape[0]
    dtype = fs.vertices.dtype

    dim = sampler_mod.DimAllocator()
    cam_dim = dim.next(sampler_mod.CAMERA_DIMS)
    if primary_rays is None:
        with timing.phase("camera", dev) as ph:
            ph.enter(camera, jitter)
            if jitter is None:
                if options.sample_pixel_center:
                    jitter = torch.full((n, 2), 0.5, dtype=dtype,
                                        device=dev)
                else:
                    jitter = sampler_mod.draw(
                        options.sampler_type, seed, pixel_ids, sample_id,
                        cam_dim, 2)
            ray, ray_diff = ph.exit(sample_primary_rays(
                camera, jitter, pixel_order=pixel_ids))
    else:
        ray, ray_diff = primary_rays

    # Swizzled camera rays are tile-coherent, and so are the edge passes'
    # Morton-sorted pairs (rays_coherent): skip the Morton sort.
    coherent = (primary_rays is None and pixel_order is not None) \
        or rays_coherent
    isect = accel.intersect(fs, ray, presorted=coherent, engine=engine)
    want_radiance = ci.radiance_dimension >= 0
    img = None  # nothing but radiance: trace_radiance fills every column
    if ci.channels != (Channels.radiance,):
        sp, _, lm = _shade_surface(fs, isect, ray, ray_diff)
        img = _accumulate_primary(fs, ci, ray, isect, sp, lm)
    surr = None
    if want_radiance:
        out = trace_radiance(
            fs, options, seed, pixel_ids, sample_id, ray, ray_diff,
            dim_start=dim.dim, primary_isect=isect, coherent=coherent,
            secondary_d_pixel=secondary_d_pixel,
            secondary_edge_table=secondary_edge_table, engine=engine,
            secondary_lane_sharding=secondary_lane_sharding,
        )
        radiance, surr = out if secondary_d_pixel is not None else (out, None)
        roff = ci.radiance_dimension
        img = radiance if img is None else torch.cat(
            [img[:, :roff], radiance, img[:, roff + 3:]], dim=-1)
    if secondary_d_pixel is None:
        return img
    if surr is None:
        surr = torch.zeros((), dtype=dtype, device=dev)
    return img, surr


def render_image(scene: Scene, options: RenderOptions, seed=0,
                 engine=None, pixel_sharding=None) -> torch.Tensor:
    """Differentiable forward render -> (vh, vw, C) image on the scene's
    device (the card unless the scene was built with device="cpu").

    torch.autograd through it gives the continuous gradients;
    render_grad.render adds the edge-sampled visibility terms.
    seed: an int (wrapped to 32 bits) or an integer tensor, taken to the
    scene's device.  engine: None = the kernels on CUDA (plain versions on
    CPU); "plain" forces the plain ray queries ("bruteforce" and "cluster"
    are its aliases, see accel.intersect).
    pixel_sharding (parallel.sharding.pixel_sharding): this rank shades its
    block of the pixels and every rank returns the whole image; under
    autograd each scene leaf's gradient is summed over the ranks, so every
    rank holds the one-process gradient.

    On a card scene the call replays cached CUDA graphs of its
    configuration (graphs.py; the first call of each graph runs eagerly,
    the second captures it), and returns a fresh tensor: when autograd is
    not recording (grad disabled, or no tensor of the scene requires
    grad) one forward graph (the JAX package's _render_image_jitted);
    under autograd a forward graph that keeps its autograd tape and a
    backward graph that takes the gradients through it (jax.grad of it;
    render_grad.graphed_render_image).  So does a pixel sharding over an
    NCCL group.  A CPU scene, a gloo group and graphs.disable() run the
    sample loop eagerly."""
    from redner_tpu_torch import graphs

    dev = scene.shapes[0].vertices.device
    with timing.entry("render_image"):
        seed = sampler_mod._as_u32(seed, dev)
        recording = torch.is_grad_enabled() and any(
            x.requires_grad for x in scene_leaves(scene))
        if graphs.replays(dev, pixel_sharding):
            if recording:
                from redner_tpu_torch.render_grad import graphed_render_image

                return graphed_render_image(scene, options, seed, engine,
                                            pixel_sharding)
            prog = graphs.program(
                "render_image", scene, options, None, engine,
                lambda s: graphs.Program(
                    s, graph_forward(options, engine, pixel_sharding)),
                pixel_sharding)
            return prog.forward(scene_tensors(scene), seed)
        if pixel_sharding is not None and recording:
            leaves = scene_leaves(scene)
            grad_leaves = [x for x in leaves if x.requires_grad]
            wrapped = iter(reduce_leaf_grads(grad_leaves, pixel_sharding))
            scene = scene_with_leaves(scene, [
                next(wrapped) if x.requires_grad else x for x in leaves])
        with timing.phase("fwd", dev):
            return _render_image_impl(scene, options, seed, engine,
                                      pixel_sharding=pixel_sharding)


def graph_forward(options: RenderOptions, engine=None, pixel_sharding=None,
                  grad=False):
    """The body of a forward CUDA graph (graphs.Program): (scene, seed) ->
    the image, under no_grad (the `fwd` phase); with grad, under autograd,
    the image carrying the tape that a graphs.KeptProgram's backward
    graph walks."""
    def forward(scene, seed):
        with torch.set_grad_enabled(grad), timing.phase("fwd", seed.device):
            return _render_image_impl(scene, options, seed, engine,
                                      pixel_sharding=pixel_sharding)
    return forward


def _render_image_impl(scene: Scene, options: RenderOptions, seed=0,
                       engine=None, secondary_d_radiance=None,
                       pixel_sharding=None):
    """render_image's sample loop (redner_tpu/render.py:1055-1190).

    secondary_d_radiance: (vh, vw, 3) radiance adjoint.  When given, the
    loop also accumulates the secondary-edge surrogate fused into the same
    wavefront, and the return value is (image, surrogate scalar).

    pixel_sharding: the n pixel lanes are padded to n_pad, a multiple of
    the world size (pad lanes shade pixel order[0], get a zero adjoint and
    are dropped), and this rank shades lanes [r n_pad / world,
    (r + 1) n_pad / world) of the swizzled order with their global pixel
    ids; the image is gathered over the ranks (core.shardutil.gather_lanes),
    the surrogate is this rank's part.  The leaves' gradients are not
    reduced here: render_image and render_grad do that once.

    options.remat with grad enabled checkpoints each pass (non-reentrant,
    so torch.autograd.grad works through it): its residuals are dropped and
    the pass re-runs in the backward, ray queries included; the RNG is
    stateless and both kernels are deterministic, so the re-run issues the
    same rays."""
    fs = flatten_scene(scene)
    if pixel_sharding is not None:
        pixel_sharding.check_device(fs.device)
    camera = scene.camera
    top, left, bottom, right = camera.viewport_or_full
    vw, vh = right - left, bottom - top
    ci = options.channel_info
    dev = fs.device
    seed = seed & 0xFFFFFFFF
    order, inverse = _swizzle_tensors(vh, vw, dev)
    n = vw * vh
    world = shard_count(pixel_sharding)
    n_pad = -(-n // world) * world
    if n_pad != n:
        order = torch.cat([order, order[:1].expand(n_pad - n)])
    lo, hi = lane_block(n_pad, shard_rank(pixel_sharding), world)
    nb = hi - lo  # this rank's lanes per sample

    # Batch K samples into the lane axis per pass when the viewport is
    # smaller than SAMPLES_LANE_TARGET lanes.  The RNG is keyed by
    # (pixel, sample), so the result equals one sample per pass up to
    # float summation order.
    spp = options.num_samples
    K = max(1, min(spp, SAMPLES_LANE_TARGET // max(n_pad, 1)))
    npass = -(-spp // K)
    order_t = order[lo:hi].repeat(K)
    sub = torch.arange(K, device=dev)
    acc = torch.zeros((nb, ci.num_total_dimensions), dtype=fs.vertices.dtype,
                      device=dev)
    surr_total = torch.zeros((), dtype=fs.vertices.dtype, device=dev)
    d_lane = edge_table = None
    if secondary_d_radiance is not None:
        # Per scene, not per sample: built once outside the loop.
        edge_table = build_edge_table(fs)
        d_flat = secondary_d_radiance.detach().reshape(-1, 3)
        d_pad = d_flat[order]
        if n_pad != n:  # pad lanes: a zero adjoint, no surrogate
            d_pad[n:] = 0.0
        d_lane = d_pad[lo:hi].repeat(K, 1)  # swizzled lanes, K samples

    def one_pass(sample_vec, d_pixel):
        return render_sample(
            fs, camera, options, seed, sample_vec, pixel_order=order_t,
            engine=engine, secondary_d_pixel=d_pixel,
            secondary_edge_table=edge_table,
            secondary_lane_sharding=pixel_sharding)

    remat = options.remat and torch.is_grad_enabled()
    for pass_id in range(npass):
        sample_ids = pass_id * K + sub
        w = (sample_ids < spp).to(acc.dtype)  # ragged-tail sample mask
        d_pixel = (None if d_lane is None
                   else d_lane * w.repeat_interleave(nb)[:, None])
        args = (sample_ids.repeat_interleave(nb), d_pixel)
        if remat:
            out = checkpoint(one_pass, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = one_pass(*args)
        if d_lane is None:
            contrib = out
        else:
            contrib, surr = out
            surr_total = surr_total + surr
        acc = acc + torch.sum(
            contrib.reshape(K, nb, ci.num_total_dimensions) * w[:, None, None],
            dim=0)
    img = gather_lanes(acc / options.num_samples, lo, n_pad, pixel_sharding)
    img = img[:n][inverse]  # lane k -> order[k]
    img = img.reshape(vh, vw, ci.num_total_dimensions)
    if d_lane is None:
        return img
    return img, surr_total / options.num_samples
