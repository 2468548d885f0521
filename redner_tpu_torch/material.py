"""Materials and the BSDF model (port of redner_tpu/material.py):
Lambertian diffuse + Blinn-Phong microfacet specular over the full sphere,
with per-lane flags for two-sidedness, normal maps and vertex colour.

All branch decisions are per-lane boolean masks; the hand-written adjoints
of the reference (d_bsdf, d_bsdf_sample, d_bsdf_pdf) are replaced by
torch autograd through this gradient-safe code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.types import RayDifferential, SurfacePoint
from redner_tpu_torch.device import resolve_device
from redner_tpu_torch.texture import Texture, make_texture

PI = math.pi


@dataclass
class Material:
    """User-facing material (pyredner/material.py:5-101)."""

    diffuse_reflectance: Texture
    specular_reflectance: Texture
    roughness: Texture
    generic_texture: Optional[Texture] = None
    normal_map: Optional[Texture] = None
    compute_specular_lighting: bool = True
    two_sided: bool = False
    use_vertex_color: bool = False


def make_material(
    diffuse_reflectance=None,
    specular_reflectance=None,
    roughness=None,
    generic_texture=None,
    normal_map=None,
    two_sided: bool = False,
    use_vertex_color: bool = False,
    dtype=torch.float32,
    device=None,
) -> Material:
    dev = resolve_device(device)
    if generic_texture is not None or normal_map is not None:
        raise NotImplementedError(
            "redner_tpu_torch: generic textures and normal maps are not "
            "ported yet (ROADMAP queue A)")

    def as_tex(x, default):
        if x is None:
            x = default
        if isinstance(x, Texture):
            return x
        return make_texture(x, dtype=dtype, device=dev)

    return Material(
        diffuse_reflectance=as_tex(diffuse_reflectance, [0.0, 0.0, 0.0]),
        specular_reflectance=as_tex(specular_reflectance, [0.0, 0.0, 0.0]),
        roughness=as_tex(roughness, [1.0]),
        compute_specular_lighting=specular_reflectance is not None,
        two_sided=two_sided,
        use_vertex_color=use_vertex_color,
    )


@dataclass
class LocalMaterial:
    """Per-lane fetched material values + per-lane static flags."""

    diffuse: torch.Tensor  # (..., 3)
    specular: torch.Tensor  # (..., 3)
    roughness: torch.Tensor  # (...,)
    normal_value: torch.Tensor  # (..., 3), zeros when no normal map
    two_sided: torch.Tensor  # (...,) bool
    use_vertex_color: torch.Tensor  # (...,) bool
    compute_specular: torch.Tensor  # (...,) bool
    has_normal_map: torch.Tensor  # (...,) bool


def roughness_to_phong(roughness):
    """phong exponent = max(2/r - 2, 0)  (src/material.h:263-265)."""
    return vm.maximum(2.0 / roughness - 2.0, 0.0)


def perturb_shading_frame(lm: LocalMaterial, sp: SurfacePoint):
    """Normal-mapped shading frame (src/material.h:274-283), applied only on
    lanes with has_normal_map."""
    n_local = 2.0 * lm.normal_value - 1.0
    n_world = vm.to_world(sp.frame_x, sp.frame_y, sp.frame_n, n_local)
    perturb_n = vm.normalize(n_world)
    npx = sp.dpdu - perturb_n * vm.vdot(perturb_n, sp.dpdu)
    perturb_x = vm.normalize(npx)
    perturb_y = vm.cross(perturb_n, perturb_x)
    m = lm.has_normal_map[..., None]
    return (
        torch.where(m, perturb_x, sp.frame_x),
        torch.where(m, perturb_y, sp.frame_y),
        torch.where(m, perturb_n, sp.frame_n),
    )


def _smith_g1(v, frame_n, roughness):
    """Smith G1 rational approximation (src/material.h:422-438)."""
    cos_theta = vm.dot(v, frame_n)
    cos2 = cos_theta * cos_theta
    ok = cos2 > 1e-12
    one = torch.ones_like(cos2)
    cos2s = torch.where(ok, cos2, one)
    tan_theta = vm.safe_sqrt(torch.where(ok, 1.0 / cos2s - 1.0,
                                         torch.zeros_like(cos2)))
    alpha = vm.safe_sqrt(roughness)
    denom = alpha * tan_theta
    big = denom > 1e-12
    a = torch.where(big, 1.0 / torch.where(big, denom, torch.ones_like(denom)),
                    torch.full_like(denom, 1e12))
    a = vm.minimum(a, 1.6)  # a >= 1.6 -> G1 = 1, and the rational == 1 there
    a_sqr = a * a
    g = (3.535 * a + 2.181 * a_sqr) / (1.0 + 2.276 * a + 2.577 * a_sqr)
    full = ((tan_theta == 0.0) | (denom <= 1e-12)
            | ((1.0 / vm.maximum(denom, 1e-12)) >= 1.6))
    return torch.where(full, torch.ones_like(g), g)


def _effective_frames(lm: LocalMaterial, sp: SurfacePoint):
    fx, fy, fn = perturb_shading_frame(lm, sp)
    geom_n = sp.geom_normal
    geom_n = torch.where(vm.dot(geom_n, fn)[..., None] < 0, -geom_n, geom_n)
    return fx, fy, fn, geom_n


def _clamped_reflectances(lm: LocalMaterial, sp: SurfacePoint):
    diffuse = torch.where(lm.use_vertex_color[..., None], sp.color, lm.diffuse)
    specular = torch.where(
        lm.use_vertex_color[..., None], torch.zeros_like(lm.specular),
        lm.specular,
    )
    return vm.maximum(diffuse, 0.0), vm.maximum(specular, 0.0)


def _pmfs(diffuse, specular):
    dw = vm.luminance(diffuse)
    sw = vm.luminance(specular)
    wsum = dw + sw
    has_w = wsum > 0
    wsum_safe = torch.where(has_w, wsum, torch.ones_like(wsum))
    half = torch.full_like(wsum, 0.5)
    diffuse_pmf = torch.where(has_w, dw / wsum_safe, half)
    specular_pmf = torch.where(has_w, sw / wsum_safe, half)
    return diffuse_pmf, specular_pmf


def bsdf(lm: LocalMaterial, sp: SurfacePoint, wi, wo, min_roughness):
    """BSDF value (src/material.h:353-449).  Batched, branchless, AD-safe."""
    fx, fy, fn, geom_n = _effective_frames(lm, sp)
    geom_wi = vm.dot(geom_n, wi)
    geom_wo = vm.dot(geom_n, wo)
    shading_wi = torch.abs(vm.dot(fn, wi))
    shading_wo = torch.abs(vm.dot(fn, wo))

    alive = geom_wi * geom_wo >= 0  # same side of geometry
    alive = alive & (lm.two_sided | ~((geom_wi < 0) & (geom_wo < 0)))
    alive = alive & ((shading_wi > 0) & (shading_wo > 1e-3)
                     & (torch.abs(geom_wo) > 1e-3))

    diffuse, specular = _clamped_reflectances(lm, sp)
    roughness = vm.maximum(lm.roughness, min_roughness)
    diffuse_contrib = diffuse * (shading_wo / PI)[..., None]

    # Blinn-Phong microfacet lobe
    m = vm.normalize(wi + wo)
    m_local_z = vm.dot(fn, m)
    m_local_z = torch.where(lm.two_sided, torch.abs(m_local_z), m_local_z)
    spec_ok = m_local_z > 0
    phong_exp = roughness_to_phong(vm.maximum(roughness, 1e-12))
    D = vm.safe_pow(vm.maximum(m_local_z, 0.0), phong_exp) * (
        phong_exp + 2.0) / (2.0 * PI)
    G = _smith_g1(wi, fn, roughness) * _smith_g1(wo, fn, roughness)
    cos_theta_d = torch.abs(vm.dot(m, wo))
    F = specular + (1.0 - specular) * vm.safe_pow(
        vm.maximum(1.0 - cos_theta_d, 0.0), 5.0
    )[..., None]
    swi = vm.maximum(shading_wi, 1e-12)
    specular_contrib = F * (D * G / (4.0 * swi))[..., None]
    specular_contrib = torch.where(
        (spec_ok & lm.compute_specular & ~lm.use_vertex_color)[..., None],
        specular_contrib,
        torch.zeros_like(specular_contrib),
    )
    val = diffuse_contrib + specular_contrib
    return torch.where(alive[..., None], val, torch.zeros_like(val))


def bsdf_pdf(lm: LocalMaterial, sp: SurfacePoint, wi, wo, min_roughness):
    """Solid-angle pdf of bsdf_sample (src/material.h:1024-1094)."""
    fx, fy, fn, geom_n = _effective_frames(lm, sp)
    geom_wi = vm.dot(geom_n, wi)
    geom_wo = vm.dot(geom_n, wo)
    shading_wo = torch.abs(vm.dot(fn, wo))

    alive = geom_wi * geom_wo >= 0
    alive = alive & (lm.two_sided | ~((geom_wi < 0) & (geom_wo < 0)))

    diffuse, specular = _clamped_reflectances(lm, sp)
    diffuse_pmf, specular_pmf = _pmfs(diffuse, specular)

    diffuse_pdf = diffuse_pmf * shading_wo / PI

    m = vm.normalize(wi + wo)
    # The reference evaluates m in the *unperturbed* shading frame here
    # (src/material.h:1078-1080) even when a normal map is present.
    m_local_z = vm.dot(sp.frame_n, m)
    m_local_z = torch.where(lm.two_sided, torch.abs(m_local_z), m_local_z)
    mdotwo = torch.abs(vm.dot(m, wo))
    spec_ok = (m_local_z > 0) & (mdotwo > 0)
    roughness = vm.maximum(vm.maximum(lm.roughness, min_roughness), 1e-6)
    phong_exp = roughness_to_phong(roughness)
    D = vm.safe_pow(vm.maximum(m_local_z, 0.0), phong_exp) * (
        phong_exp + 2.0) / (2.0 * PI)
    specular_pdf = specular_pmf * D * m_local_z / (
        4.0 * vm.maximum(mdotwo, 1e-12))
    zero = torch.zeros_like(specular_pdf)
    specular_pdf = torch.where(spec_ok & (specular_pmf > 0), specular_pdf,
                               zero)
    pdf = torch.where(diffuse_pmf > 0, diffuse_pdf, zero) + specular_pdf
    return torch.where(alive, pdf, zero)


def cos_hemisphere(sample):
    """Cosine-weighted hemisphere sample (src/material.h:694-700)."""
    phi = 2.0 * PI * sample[..., 0]
    tmp = vm.safe_sqrt(1.0 - sample[..., 1])
    return torch.stack(
        [torch.cos(phi) * tmp, torch.sin(phi) * tmp,
         vm.safe_sqrt(sample[..., 1])],
        dim=-1,
    )


def bsdf_sample(
    lm: LocalMaterial,
    sp: SurfacePoint,
    wi,
    sample_w,
    sample_uv,
    min_roughness,
    wi_diff: RayDifferential,
):
    """Sample an outgoing direction (src/material.h:704-812).

    Returns (wo (...,3), wo_diff RayDifferential, next_min_roughness (...,)).
    Invalid lanes (one-sided surface seen from behind) return wo=0.
    """
    fx, fy, fn, geom_n = _effective_frames(lm, sp)
    geom_wi = vm.dot(geom_n, wi)
    alive = lm.two_sided | (geom_wi >= 0)

    diffuse, specular = _clamped_reflectances(lm, sp)
    diffuse_pmf, _ = _pmfs(diffuse, specular)
    take_diffuse = sample_w <= diffuse_pmf

    # --- Diffuse branch ---
    local_dir = cos_hemisphere(sample_uv)
    dir_d = vm.to_world(fx, fy, fn, local_dir)
    flip_d = vm.dot(geom_n, dir_d) * geom_wi < 0
    dir_d = torch.where(flip_d[..., None], vm.to_world(fx, fy, fn, -local_dir),
                        dir_d)
    # Diffuse lobe low-pass prefilter hack (src/material.h:760-761)
    diffuse_prefilter = torch.full_like(dir_d, 0.03)

    # --- Specular (Blinn-Phong) branch ---
    roughness = vm.maximum(vm.maximum(lm.roughness, min_roughness), 1e-6)
    phong_exp = roughness_to_phong(roughness)
    phi = 2.0 * PI * sample_uv[..., 1]
    cos_theta = vm.safe_pow(vm.maximum(sample_uv[..., 0], 1e-20),
                            1.0 / (phong_exp + 2.0))
    sin_theta = vm.safe_sqrt(1.0 - cos_theta * cos_theta)
    m_local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )
    m = vm.to_world(fx, fy, fn, m_local)
    dir_s = 2.0 * vm.vdot(wi, m) * m - wi
    flip_s = vm.dot(geom_n, dir_s) * geom_wi < 0
    m_flip = vm.to_world(fx, fy, fn, -m_local)
    dir_s_f = 2.0 * vm.vdot(wi, m_flip) * m_flip - wi
    m = torch.where(flip_s[..., None], m_flip, m)
    m_local = torch.where(flip_s[..., None], -m_local, m_local)
    dir_s = torch.where(flip_s[..., None], dir_s_f, dir_s)
    # Igehy-style specular ray differentials (src/material.h:795-809)
    dmdx = sp.dn_dx * m_local[..., 2:3]
    dmdy = sp.dn_dy * m_local[..., 2:3]
    wi_dx = -wi_diff.dir_dx
    wi_dy = -wi_diff.dir_dy
    widotm_dx = vm.vdot(wi_dx, m) + vm.vdot(wi, dmdx)
    widotm_dy = vm.vdot(wi_dy, m) + vm.vdot(wi, dmdy)
    dir_s_dx = 2.0 * (vm.vdot(wi, m) * dmdx + widotm_dx * m) - wi_dx
    dir_s_dy = 2.0 * (vm.vdot(wi, m) * dmdy + widotm_dy * m) - wi_dy

    td = take_diffuse[..., None]
    wo = torch.where(td, dir_d, dir_s)
    wo = torch.where(alive[..., None], wo, torch.zeros_like(wo))
    wo_diff = RayDifferential(
        org_dx=wi_diff.org_dx,
        org_dy=wi_diff.org_dy,
        dir_dx=torch.where(td, diffuse_prefilter, dir_s_dx),
        dir_dy=torch.where(td, diffuse_prefilter, dir_s_dy),
    )
    next_min_roughness = torch.where(
        take_diffuse, torch.ones_like(roughness),
        vm.maximum(roughness, min_roughness),
    )
    next_min_roughness = torch.where(alive, next_min_roughness,
                                     min_roughness.expand_as(roughness))
    return wo, wo_diff, next_min_roughness
