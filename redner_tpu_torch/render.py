"""The differentiable wavefront path tracer, forward path (port of
redner_tpu/render.py; reference src/pathtracer.cpp:177-945).

Every lane of a fixed (num_lanes,) axis is one pixel-sample; activity is a
boolean mask.  Discrete quantities (hit ids, occlusion, RNG, CDF picks) are
detached, so torch autograd of `render_image` gives the continuous
(AD-only) gradients that `jax.grad(redner_tpu.render_image)` gives.  The
code runs eagerly: the sample loop and bounce loop are Python loops.

Not ported yet (they raise): AOV channels other than radiance, environment
maps, the Sobol sampler, edge sampling (secondary-edge fusion, the
custom-gradient `render`), intersection replay, remat and sharding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

import redner_tpu_torch.sampler as sampler_mod
from redner_tpu_torch import accel
from redner_tpu_torch.camera import Camera, sample_primary_rays
from redner_tpu_torch.channels import ChannelInfo, Channels
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import (Intersection, Ray, RayDifferential,
                                         SurfacePoint)
from redner_tpu_torch.geometry import build_surface_point, sample_tri_point
from redner_tpu_torch.material import bsdf, bsdf_pdf, bsdf_sample
from redner_tpu_torch.sampler import SamplerType
from redner_tpu_torch.scene import (FlatScene, Scene, fetch_local_material,
                                    flatten_scene, gather_face_corner_attribs,
                                    gather_face_vertices)


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
        # Shadow rays through the any-hit kernel, continuation rays through
        # the closest-hit kernel; the batched single sweep is not ported.
        self.split_shadow_sweep = bool(split_shadow_sweep)
        self.isect_replay_max_mb = float(isect_replay_max_mb)
        self._frozen = True

    def __setattr__(self, name, value):
        if getattr(self, "_frozen", False):
            raise AttributeError(
                "RenderOptions is frozen after construction; build a new one")
        object.__setattr__(self, name, value)


def _surface_point_at(fs: FlatScene, isect: Intersection, ray: Ray,
                      ray_diff: RayDifferential):
    """Differentiable surface point from a (non-diff) hit record.

    Missed lanes re-derive a point on a clamped triangle whose values can
    be huge; they are replaced at the source by a benign on-origin point
    with unit frames so no NaN reaches a gradient through 0*inf."""
    v0, v1, v2 = gather_face_vertices(fs, isect.tri_id)
    (uv0, uv1, uv2, n0, n1, n2, has_n, c0, c1, c2) = gather_face_corner_attribs(
        fs, isect.tri_id
    )
    sp, rd = build_surface_point(
        v0, v1, v2, uv0, uv1, uv2, n0, n1, n2, has_n, c0, c1, c2, ray, ray_diff
    )
    m3 = isect.valid[..., None]
    kw = dict(dtype=sp.position.dtype, device=sp.position.device)
    ex = torch.tensor([1.0, 0.0, 0.0], **kw)
    ey = torch.tensor([0.0, 1.0, 0.0], **kw)
    ez = torch.tensor([0.0, 0.0, 1.0], **kw)
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
    intensity = fs.light_intensity[lid_c]
    two_sided = fs.light_two_sided[lid_c]
    ok = is_light & (two_sided | (wi_dot_n > 0))
    if camera_ray:
        ok = ok & fs.light_directly_visible[lid_c]
    return torch.where(ok[..., None], intensity,
                       torch.zeros_like(intensity)), is_light


def _sample_light_point(fs: FlatScene, sp_pos, light_uniforms):
    """NEE light/triangle/point selection (src/scene.cpp:692-759).

    light_uniforms: (n, 4) = (light_sel, tri_sel, uv0, uv1).
    Returns a dict with the shadow Ray and the light point data."""
    n = sp_pos.shape[0]
    kw = dict(dtype=sp_pos.dtype, device=sp_pos.device)
    light_id = torch.clamp(
        vm.searchsorted_right(fs.light_cdf, light_uniforms[:, 0]) - 1,
        0, fs.num_lights - 1,
    )
    lidx = torch.clamp(light_id, 0, fs.num_area_lights - 1)
    row_cdf = fs.light_tri_cdf[lidx]  # (n, Tmax)
    tri_ofs = torch.clamp(
        vm.searchsorted_right(row_cdf, light_uniforms[:, 1]) - 1,
        0, row_cdf.shape[-1] - 1,
    )
    face = fs.light_tri_face[lidx, tri_ofs]
    v0, v1, v2 = gather_face_vertices(fs, face)
    lpos, lnormal, _ = sample_tri_point(v0, v1, v2, light_uniforms[:, 2:4])
    # The light-sample chain is frozen w.r.t. light geometry: AD carries only
    # the smooth integrand terms; the secondary-edge pass supplies the
    # boundary term (redner_tpu/render.py:369-379).
    lpos = lpos.detach()
    lnormal = lnormal.detach()
    ldir = lpos - sp_pos
    dist = vm.length(ldir)
    wo = vm.normalize(ldir)
    shadow_ray = Ray(
        org=sp_pos,
        dir=wo,
        tmin=torch.full((n,), 1e-3, **kw),
        tmax=(1.0 - 1e-3) * dist.detach(),
    )
    return {
        "area_light_id": lidx,
        "light_pos": lpos,
        "light_normal": lnormal,
        "shadow_ray": shadow_ray,
    }


def _nee_contribution(fs, lm, sp, wi, min_rough, ls, blocked):
    """NEE contribution with MIS (src/path_contribution.cpp:28-70)."""
    lidx = ls["area_light_id"]
    lpos = ls["light_pos"]
    lnormal = ls["light_normal"]
    dirv = lpos - sp.position
    dist_sq = vm.length_squared(dirv)
    ok = dist_sq > 1e-20
    wo = vm.normalize(dirv)
    intensity = fs.light_intensity[lidx]
    two_sided = fs.light_two_sided[lidx]
    front = two_sided | (vm.dot(-wo, lnormal) > 0)
    bsdf_val = bsdf(lm, sp, wi, wo, min_rough)
    geom_term = vm.safe_div(torch.abs(vm.dot(wo, lnormal)), dist_sq)
    pdf_nee = vm.safe_div(fs.light_pmf[lidx], fs.light_areas[lidx])
    pdf_b = bsdf_pdf(lm, sp, wi, wo, min_rough) * geom_term
    mis = 1.0 / (1.0 + vm.square(vm.safe_div(pdf_b, pdf_nee)))
    contrib = (
        (mis * geom_term * vm.safe_div(torch.ones_like(pdf_nee), pdf_nee))[..., None]
        * bsdf_val
        * intensity
    )
    ok = ok & front & (pdf_nee > 0) & ~blocked
    return torch.where(ok[..., None], contrib, torch.zeros_like(contrib))


def _face_emission_nee(fs, isect, wo, sp_light):
    """Emission of a BSDF-sampled hit toward -wo, with two-sided test
    (src/path_contribution.cpp:80-90)."""
    tid = torch.clamp(isect.tri_id, 0, fs.num_triangles - 1)
    lid = fs.face_light_id[tid]
    is_light = isect.valid & (lid >= 0)
    if fs.num_area_lights == 0:
        return torch.zeros_like(wo), is_light
    lidc = torch.clamp(lid, 0, fs.num_area_lights - 1)
    intensity = fs.light_intensity[lidc]
    two_sided = fs.light_two_sided[lidc]
    front = two_sided | (vm.dot(-wo, sp_light.frame_n) > 0)
    ok = is_light & front
    return torch.where(ok[..., None], intensity,
                       torch.zeros_like(intensity)), ok


def _scatter_contribution(fs, lm, sp, wi, min_rough, bsdf_isect, bsdf_sp):
    """BSDF-sampling contribution with MIS + throughput update factor
    (src/path_contribution.cpp:71-127).  Returns (scatter_contrib (n,3),
    scatter_bsdf (n,3) = bsdf/pdf for the throughput update)."""
    hit = bsdf_isect.valid
    dirv = bsdf_sp.position - sp.position
    dist_sq = vm.length_squared(dirv)
    # Missed rays re-derive a point that can coincide with the shading
    # plane; normalize(~0) has NaN derivatives that leak through where.
    dir_ok = hit & (dist_sq > 1e-20)
    safe_dirv = torch.where(
        dir_ok[..., None], dirv,
        torch.tensor([0.0, 0.0, 1.0], dtype=dirv.dtype, device=dirv.device),
    )
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
    coherent: bool = False,
    engine=None,
):
    """Full-path radiance estimate for arbitrary primary rays -> (n, 3)
    (redner_tpu/render.py:572-797, without the secondary-edge, replay and
    envmap branches).

    lane_ids keys the RNG; dim_start is the first sample dimension drawn.
    coherent: rays are tile-coherent (swizzled pixels), so the ray queries
    skip their Morton sort.  engine: see accel.intersect.
    """
    n = ray.org.shape[0]
    kw = dict(dtype=ray.org.dtype, device=ray.org.device)
    radiance = torch.zeros((n, 3), **kw)

    isect = (accel.intersect(fs, ray, presorted=coherent, engine=engine)
             if primary_isect is None else primary_isect)
    sp, ray_diff = _surface_point_at(fs, isect, ray, ray_diff)
    mid = fs.face_material_id[torch.clamp(isect.tri_id, 0, fs.num_triangles - 1)]
    lm = fetch_local_material(fs, sp, mid)

    if include_primary_emission:
        emission, _ = _face_emission(
            fs, isect.tri_id, vm.dot(-ray.dir, sp.frame_n), camera_ray=camera_ray
        )
        radiance = radiance + torch.where(isect.valid[..., None], emission,
                                          torch.zeros_like(emission))

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

        bsdf_u = sampler_mod.draw(
            options.sampler_type, seed, lane_ids, sample_id, bsdf_dim, 3
        )
        wo, wo_diff, next_min_rough = bsdf_sample(
            lm, sp, wi, bsdf_u[:, 0], bsdf_u[:, 1:3], min_rough, incoming_diff
        )
        bsdf_ray = Ray(
            org=sp.position,
            dir=torch.where(active[..., None], wo, torch.zeros_like(wo)),
            tmin=torch.full((n,), 1e-3, **kw),
            tmax=torch.full((n,), float("inf"), **kw),
        )
        # Every sweep below starts ON scene geometry; the port's queries are
        # exact f32 everywhere, so `precise` has nothing to select.
        if fs.num_lights > 0:
            light_u = sampler_mod.draw(
                options.sampler_type, seed, lane_ids, sample_id, light_dim, 4
            )
            ls = _sample_light_point(fs, sp.position, light_u)
            sray = ls["shadow_ray"]
            blocked = accel.occluded(fs, sray, presorted=coherent,
                                     engine=engine)
            bsdf_isect = accel.intersect(fs, bsdf_ray, presorted=coherent,
                                         engine=engine)
            nee = _nee_contribution(fs, lm, sp, wi, min_rough, ls, blocked)
        else:
            nee = torch.zeros((n, 3), **kw)
            bsdf_isect = accel.intersect(fs, bsdf_ray, presorted=coherent,
                                         engine=engine)
        bsdf_sp, bsdf_diff = _surface_point_at(fs, bsdf_isect, bsdf_ray, wo_diff)

        scatter, scatter_bsdf = _scatter_contribution(
            fs, lm, sp, wi, min_rough, bsdf_isect, bsdf_sp
        )
        contrib = throughput * (nee + scatter)
        radiance = radiance + torch.where(active[..., None], contrib,
                                          torch.zeros_like(contrib))

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
        mid = fs.face_material_id[
            torch.clamp(bsdf_isect.tri_id, 0, fs.num_triangles - 1)
        ]
        lm = fetch_local_material(fs, sp, mid)
    return radiance


SWIZZLE_BLOCK = (16, 32)  # (rows, cols) of one screen block of lanes

# Target lane count per pass of the image loop: samples are batched into the
# lane axis until roughly this many lanes per pass.
SAMPLES_LANE_TARGET = 1 << 16


def swizzle_order(vh: int, vw: int):
    """Static pixel permutation grouping 16x32 screen blocks contiguously, so
    ray tiles have tight frusta and the chunk culling prunes.  Returns
    (order, inverse) as numpy int64 (order[k] = flat pixel of lane k)."""
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


def _check_supported(options: RenderOptions):
    ci = options.channel_info
    if ci.channels != (Channels.radiance,):
        raise NotImplementedError(
            "redner_tpu_torch: only the radiance channel is ported yet "
            f"(asked for {[c.name for c in ci.channels]}; ROADMAP queue A)")
    if options.remat:
        raise NotImplementedError(
            "redner_tpu_torch: remat is not ported yet (ROADMAP queue A)")
    if not options.split_shadow_sweep:
        raise NotImplementedError(
            "redner_tpu_torch: split_shadow_sweep=False (shadow and "
            "continuation rays in one closest-hit sweep) is not ported; "
            "shadow rays go through the any-hit kernel")


def render_sample(
    fs: FlatScene,
    camera: Camera,
    options: RenderOptions,
    seed,
    sample_id,
    pixel_order=None,
    engine=None,
):
    """Trace one sample per lane; returns the (num_lanes, C) contribution
    (unweighted; the caller averages), lane k = pixel pixel_order[k]
    (identity when None).  The RNG is keyed by the true pixel id."""
    _check_supported(options)
    ci = options.channel_info
    top, left, bottom, right = camera.viewport_or_full
    dev = fs.device
    if pixel_order is None:
        pixel_ids = torch.arange((right - left) * (bottom - top), device=dev)
    else:
        pixel_ids = torch.as_tensor(pixel_order, dtype=torch.int64, device=dev)
    n = pixel_ids.shape[0]
    dtype = fs.vertices.dtype

    dim = sampler_mod.DimAllocator()
    cam_dim = dim.next(sampler_mod.CAMERA_DIMS)
    if options.sample_pixel_center:
        jitter = torch.full((n, 2), 0.5, dtype=dtype, device=dev)
    else:
        jitter = sampler_mod.draw(
            options.sampler_type, seed, pixel_ids, sample_id, cam_dim, 2
        )
    ray, ray_diff = sample_primary_rays(camera, jitter, pixel_order=pixel_ids)

    # Swizzled primary rays are already tile-coherent: skip the Morton sort.
    coherent = pixel_order is not None
    isect = accel.intersect(fs, ray, presorted=coherent, engine=engine)
    radiance = trace_radiance(
        fs, options, seed, pixel_ids, sample_id, ray, ray_diff,
        dim_start=dim.dim, primary_isect=isect, coherent=coherent,
        engine=engine,
    )
    img = torch.zeros((n, ci.num_total_dimensions), dtype=dtype, device=dev)
    roff = ci.radiance_dimension
    return torch.cat([img[:, :roff], radiance, img[:, roff + 3:]], dim=-1)


def render_image(scene: Scene, options: RenderOptions, seed=0,
                 engine=None) -> torch.Tensor:
    """Differentiable forward render -> (vh, vw, C) image on the scene's
    device (the card unless the scene was built with device="cpu").

    torch.autograd through it gives the continuous gradients.
    engine: None = the kernels on CUDA (plain versions on CPU); "plain"
    forces the plain ray queries (see accel.intersect)."""
    _check_supported(options)
    fs = flatten_scene(scene)
    camera = scene.camera
    top, left, bottom, right = camera.viewport_or_full
    vw, vh = right - left, bottom - top
    ci = options.channel_info
    dev = fs.device
    seed = int(seed) & 0xFFFFFFFF
    order_np, inverse_np = swizzle_order(vh, vw)
    order = torch.as_tensor(order_np, device=dev)

    # Batch K samples into the lane axis per pass when the viewport is
    # smaller than SAMPLES_LANE_TARGET lanes.  The RNG is keyed by
    # (pixel, sample), so the result equals one sample per pass up to
    # float summation order.
    n = vw * vh
    spp = options.num_samples
    K = max(1, min(spp, SAMPLES_LANE_TARGET // max(n, 1)))
    npass = -(-spp // K)
    order_t = order.repeat(K)
    sub = torch.arange(K, device=dev)
    acc = torch.zeros((n, ci.num_total_dimensions), dtype=fs.vertices.dtype,
                      device=dev)
    for pass_id in range(npass):
        sample_ids = pass_id * K + sub
        contrib = render_sample(
            fs, camera, options, seed, sample_ids.repeat_interleave(n),
            pixel_order=order_t, engine=engine,
        )
        w = (sample_ids < spp).to(contrib.dtype)
        acc = acc + torch.sum(
            contrib.reshape(K, n, ci.num_total_dimensions) * w[:, None, None],
            dim=0)
    img = acc / options.num_samples
    img = img[torch.as_tensor(inverse_np, device=dev)]  # lane k -> order[k]
    return img.reshape(vh, vw, ci.num_total_dimensions)
