"""The plain reference renderer: what the port's timed path is judged
against.  Written from the published model of redner (Li et al. 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling", and
redner's documented shading, light and sampler conventions), not from the
port's code: no acceleration layout, no activity mask, no chunks, no
batching of samples into lanes, no CUDA graphs.

What it renders: a scene of triangle meshes with constant materials
(Lambertian diffuse plus a Blinn-Phong microfacet lobe with a Smith
shadowing term and Schlick's Fresnel), quad area lights, a perspective
camera with a pinhole and sub-pixel jitter, next-event estimation and
BSDF sampling joined by the power heuristic, and `max_bounces` bounces.
Every ray query is a brute-force Moller-Trumbore test of each ray against
every triangle.  Its gradients are torch autograd through this code: the
continuous (interior) gradients, which is what the port's `render` returns
with both edge samplers off.  The edge terms are edges.py's.

Random numbers follow the renderer's stated stream: u(seed, pixel,
sample, dim) is the first, second, third or fourth output of the PCG4D
hash (Jarzynski and Olano, JCGT 2020) of (seed, pixel, sample, d), d the
first dimension of a group of four, as a float in [0, 1) from its top 24
bits.  Per path: dims 0-1 the pixel jitter, then per bounce four light
dims (light, triangle, two for the point) and three BSDF dims (lobe, two
for the direction).

It imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

import torch

M32 = 0xFFFFFFFF
TMIN_SECONDARY = 1e-3  # secondary rays start this far along
DET_EPS = 1e-8  # |det| at or below it: the ray grazes the triangle
QUERY_ELEMENTS = 1 << 24  # rays x triangles per block of a ray query
LANES = 1 << 16  # camera paths per block of the sample loop
LUM = (0.212671, 0.715160, 0.072169)  # Rec. 709 luminance

# "tf32": the control.  The operands of every ray-triangle product are
# rounded to TF32's 10 mantissa bits, the step below the float32 with TF32
# off that the configurations state.
PRECISION = {"mode": "fp32"}


# ----------------------------------------------------------------------
# Random numbers
# ----------------------------------------------------------------------

def _mulmod(a, b):
    """a * b mod 2^32, both int64 tensors in [0, 2^32), without leaving
    int64: b split into 16-bit halves."""
    lo = (a * (b & 0xFFFF)) & M32
    hi = (((a * (b >> 16)) & 0xFFFF) << 16) & M32
    return (lo + hi) & M32


def pcg4d(v):
    """PCG4D of four uint32 streams (a list of int64 tensors)."""
    v = [(_mulmod(x, torch.full_like(x, 1664525)) + 1013904223) & M32
         for x in v]

    def mix(v):
        a, b, c, d = v
        a = (a + _mulmod(b, d)) & M32
        b = (b + _mulmod(c, a)) & M32
        c = (c + _mulmod(a, b)) & M32
        d = (d + _mulmod(b, c)) & M32
        return [a, b, c, d]

    v = mix(v)
    v = [x ^ (x >> 16) for x in v]
    return mix(v)


def uniforms(seed, pixel, sample, dim, n):
    """(lanes, n) floats in [0, 1): dims dim .. dim + n - 1 of each lane."""
    cols = []
    for g in range(0, n, 4):
        key = [torch.full_like(pixel, int(seed) & M32), pixel & M32,
               sample & M32, torch.full_like(pixel, (dim + g) & M32)]
        for w in pcg4d(key)[:min(4, n - g)]:
            cols.append((w >> 8).to(torch.float32) / float(1 << 24))
    return torch.stack(cols, -1)


# ----------------------------------------------------------------------
# Scene
# ----------------------------------------------------------------------

@dataclass
class Mesh:
    vertices: torch.Tensor  # (V, 3)
    faces: torch.Tensor  # (F, 3) int64
    uvs: Optional[torch.Tensor] = None  # (V, 2); none: (0,0) (1,0) (1,1)
    normals: Optional[torch.Tensor] = None  # (V, 3) shading normals
    diffuse: Optional[torch.Tensor] = None  # (3,)
    specular: Optional[torch.Tensor] = None  # (3,); None: no specular lobe
    roughness: Optional[torch.Tensor] = None  # (1,)
    emission: Optional[torch.Tensor] = None  # (3,): an area light


@dataclass
class Camera:
    position: torch.Tensor
    look_at: torch.Tensor
    up: torch.Tensor
    fov_deg: float
    height: int
    width: int


@dataclass
class Scene:
    camera: Camera
    meshes: List[Mesh] = field(default_factory=list)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    """v / |v|; zero vectors stay zero (and pass no gradient)."""
    n2 = _dot(v, v)
    ok = n2 > 0
    return v * torch.where(ok, torch.rsqrt(torch.where(ok, n2, 1.0)),
                           0.0)[..., None]


def _sqrt0(x):
    ok = x > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _pow0(x, e):
    ok = x > 0
    return torch.where(ok, torch.pow(torch.where(ok, x, 1.0), e), 0.0)


def _lum(c):
    return LUM[0] * c[..., 0] + LUM[1] * c[..., 1] + LUM[2] * c[..., 2]


def _tf32(x):
    """x rounded to 10 mantissa bits (round to nearest) in tf32 mode."""
    if PRECISION["mode"] != "tf32":
        return x
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclass
class Flat:
    """All meshes' triangles in one list, shapes in order."""
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    n: torch.Tensor  # (F, 3, 3) corner shading normals
    has_n: torch.Tensor  # (F,) bool
    uv: torch.Tensor  # (F, 3, 2)
    mesh: torch.Tensor  # (F,) int64 mesh id
    meshes: list
    parts: list  # per mesh: (first, end, bounding center, radius)


def flatten(scene):
    v0, v1, v2, ns, hn, uvs, mid = [], [], [], [], [], [], []
    for i, m in enumerate(scene.meshes):
        f = m.faces
        v = m.vertices
        v0.append(v[f[:, 0]])
        v1.append(v[f[:, 1]])
        v2.append(v[f[:, 2]])
        F = f.shape[0]
        if m.normals is not None:
            ns.append(m.normals[f])
            hn.append(torch.ones(F, dtype=torch.bool, device=v.device))
        else:
            ns.append(torch.zeros((F, 3, 3), device=v.device))
            hn.append(torch.zeros(F, dtype=torch.bool, device=v.device))
        if m.uvs is not None:
            uvs.append(m.uvs[f])
        else:
            uvs.append(torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]],
                                    device=v.device).expand(F, 3, 2))
        mid.append(torch.full((F,), i, dtype=torch.int64, device=v.device))
    parts, first = [], 0
    for m in scene.meshes:
        v = m.vertices.detach()[m.faces.reshape(-1)]
        c = 0.5 * (v.amin(0) + v.amax(0))
        r = torch.linalg.vector_norm(v - c, dim=-1).amax()
        parts.append((first, first + m.faces.shape[0], c, r))
        first += m.faces.shape[0]
    cat = torch.cat
    return Flat(cat(v0), cat(v1), cat(v2), cat(ns), cat(hn), cat(uvs),
                cat(mid), scene.meshes, parts)


# ----------------------------------------------------------------------
# Ray queries: every ray against every triangle
# ----------------------------------------------------------------------

def _tests(org, d, v0, e1, e2, tmin, tmax):
    """(B, F) hit mask and t of the Moller-Trumbore test, one component
    at a time: (rays, 1) against (1, triangles)."""
    ox, oy, oz = (_tf32(org)[:, i:i + 1] for i in range(3))
    dx, dy, dz = (_tf32(d)[:, i:i + 1] for i in range(3))
    ax, ay, az = (_tf32(v0)[None, :, i] for i in range(3))
    bx, by, bz = (_tf32(e1)[None, :, i] for i in range(3))
    cx, cy, cz = (_tf32(e2)[None, :, i] for i in range(3))
    px, py, pz = dy * cz - dz * cy, dz * cx - dx * cz, dx * cy - dy * cx
    det = bx * px + by * py + bz * pz
    ok = det.abs() > DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = (sx * px + sy * py + sz * pz) * inv
    del px, py, pz
    qx, qy, qz = sy * bz - sz * by, sz * bx - sx * bz, sx * by - sy * bx
    del sx, sy, sz
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (cx * qx + cy * qy + cz * qz) * inv
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t > tmin[:, None]) & (t < tmax[:, None]))
    return hit, t


def _near(org, d, tmin, tmax, center, radius):
    """Indices of the rays whose segment [tmin, tmax] may meet the sphere
    (center, radius): a mesh's bound, widened so that no rounding drops a
    ray that meets a triangle inside it."""
    r = radius * (1.0 + 1e-3) + 1e-4
    oc = center - org
    tca = _dot(oc, d)
    d2 = _dot(oc, oc) - tca * tca
    half = torch.sqrt((r * r - d2).clamp_min(0.0))
    ok = (d2 <= r * r) & (tca + half >= tmin) & (tca - half <= tmax)
    return torch.nonzero(ok | ((oc * oc).sum(-1) <= r * r))[:, 0]


def _sweep(fl, org, d, tmin, tmax, per_block):
    """Call per_block(rays, first, end, hit, t) for every block of the
    rays near each mesh's bound against that mesh's triangles."""
    v0 = fl.v0.detach()
    e1, e2 = fl.v1.detach() - v0, fl.v2.detach() - v0
    for first, end, c, r in fl.parts:
        near = _near(org, d, tmin, tmax, c, r)
        step = max(1, QUERY_ELEMENTS // (end - first))
        for a in range(0, near.shape[0], step):
            rays = near[a:a + step]
            hit, t = _tests(org[rays], d[rays], v0[first:end],
                            e1[first:end], e2[first:end], tmin[rays],
                            tmax[rays])
            per_block(rays, first, hit, t)


@torch.no_grad()
def closest_hit(fl, org, d, tmin, tmax):
    """(rays,) index of the nearest triangle hit, -1 where none; of equal
    distances the lowest index."""
    best_t = torch.full((org.shape[0],), math.inf, device=org.device)
    best_i = torch.full((org.shape[0],), -1, dtype=torch.int64,
                        device=org.device)

    def block(rays, first, hit, t):
        t, arg = torch.where(hit, t, math.inf).min(dim=1)
        better = t < best_t[rays]
        best_t[rays] = torch.where(better, t, best_t[rays])
        best_i[rays] = torch.where(better, first + arg, best_i[rays])

    _sweep(fl, org, d, tmin, tmax, block)
    return best_i


@torch.no_grad()
def any_hit(fl, org, d, tmin, tmax):
    """(rays,) bool: some triangle lies between tmin and tmax."""
    out = torch.zeros((org.shape[0],), dtype=torch.bool, device=org.device)

    def block(rays, first, hit, t):
        out[rays] |= hit.any(1)

    _sweep(fl, org, d, tmin, tmax, block)
    return out


# ----------------------------------------------------------------------
# Camera, surface points, materials, lights
# ----------------------------------------------------------------------

def camera_rays(cam, pixel, jitter):
    """Pinhole rays through (pixel + jitter) of a look-at camera."""
    fwd = _unit(cam.look_at - cam.position)
    right = _unit(_cross(fwd, _unit(cam.up)))
    up = _unit(_cross(right, fwd))
    W, H = cam.width, cam.height
    sx = ((pixel % W).to(torch.float32) + jitter[:, 0]) / W
    sy = ((pixel // W).to(torch.float32) + jitter[:, 1]) / H
    tan_half = math.tan(math.radians(0.5 * cam.fov_deg))
    local = torch.stack([(sx - 0.5) * 2.0 * tan_half,
                         (sy - 0.5) * (-2.0 * H / W) * tan_half,
                         torch.ones_like(sx)], -1)
    local = _unit(local)
    d = _unit(local[:, 0:1] * right + local[:, 1:2] * up
              + local[:, 2:3] * fwd)
    return cam.position.expand_as(d), d


def _onb(n):
    """Tangent and bitangent of unit n (Duff et al. 2017)."""
    low = n[..., 2] < -1.0 + 1e-6
    a = 1.0 / torch.where(low, 1.0, 1.0 + n[..., 2])
    b = -n[..., 0] * n[..., 1] * a
    x = torch.stack([1.0 - n[..., 0] ** 2 * a, b, -n[..., 0]], -1)
    y = torch.stack([b, 1.0 - n[..., 1] ** 2 * a, -n[..., 1]], -1)
    x = torch.where(low[..., None], x.new_tensor([0.0, -1.0, 0.0]), x)
    y = torch.where(low[..., None], y.new_tensor([-1.0, 0.0, 0.0]), y)
    return x, y


@dataclass
class Hit:
    pos: torch.Tensor
    ng: torch.Tensor  # geometric normal, on the shading normal's side
    fx: torch.Tensor  # shading frame
    fy: torch.Tensor
    fn: torch.Tensor
    mesh: torch.Tensor


def surface(fl, tri, org, d):
    """The hit point of rays (org, d) on triangles `tri`, differentiable
    in the vertices and the rays."""
    v0, v1, v2 = fl.v0[tri], fl.v1[tri], fl.v2[tri]
    e1, e2 = v1 - v0, v2 - v0
    p = _cross(d, e2)
    det = _dot(e1, p)
    det = torch.where(det >= 0, 1.0, -1.0) * det.abs().clamp_min(DET_EPS)
    s = org - v0
    q = _cross(s, e1)
    u = _dot(s, p) / det
    v = _dot(d, q) / det
    t = _dot(e2, q) / det
    pos = org + d * t[:, None]
    ng = _unit(_cross(e1, e2))
    ng_onb = _onb(ng)[0]
    w = 1.0 - u - v
    nc = fl.n[tri]
    ns = w[:, None] * nc[:, 0] + u[:, None] * nc[:, 1] + v[:, None] * nc[:, 2]
    has_n = fl.has_n[tri] & (_dot(ns, ns) > 0)
    fn = torch.where(has_n[:, None], _unit(ns), ng)
    ng = torch.where((has_n & (_dot(ng, fn) < 0))[:, None], -ng, ng)
    # Tangent from the uv parameterisation, orthonormalised against fn.
    uv = fl.uv[tri]
    d02, d12 = uv[:, 0] - uv[:, 2], uv[:, 1] - uv[:, 2]
    uv_det = d02[:, 0] * d12[:, 1] - d02[:, 1] * d12[:, 0]
    has_uv = uv_det != 0
    dpdu = ((d12[:, 1:2] * (v0 - v2) - d02[:, 1:2] * (v1 - v2))
            / torch.where(has_uv, uv_det, 1.0)[:, None])
    dpdu = torch.where(has_uv[:, None], dpdu, ng_onb)
    fy = _cross(fn, _unit(dpdu))
    fy_ok = _dot(fy, fy) > 0
    fy = _unit(fy)
    fx = _cross(fy, fn)
    ox, oy = _onb(fn)
    fx = torch.where(fy_ok[:, None], fx, ox)
    fy = torch.where(fy_ok[:, None], fy, oy)
    return Hit(pos, ng, fx, fy, fn, fl.mesh[tri])


@dataclass
class Mat:
    kd: torch.Tensor  # (n, 3)
    ks: torch.Tensor  # (n, 3)
    rough: torch.Tensor  # (n,)
    spec_on: torch.Tensor  # (n,) bool


def materials(fl, mesh_ids):
    """Per-lane material values of the hit meshes."""
    n = mesh_ids.shape[0]
    dev = mesh_ids.device
    kd = torch.zeros((n, 3), device=dev)
    ks = torch.zeros((n, 3), device=dev)
    rough = torch.ones((n,), device=dev)
    on = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i, m in enumerate(fl.meshes):
        sel = (mesh_ids == i)
        if m.diffuse is not None:
            kd = torch.where(sel[:, None], m.diffuse, kd)
        if m.specular is not None:
            ks = torch.where(sel[:, None], m.specular, ks)
            on = on | sel
        if m.roughness is not None:
            rough = torch.where(sel, m.roughness[0], rough)
    return Mat(kd.clamp_min(0.0), ks.clamp_min(0.0), rough, on)


def _lobe_pmfs(mat):
    wd, ws = _lum(mat.kd), _lum(mat.ks)
    tot = wd + ws
    ok = tot > 0
    tot = torch.where(ok, tot, 1.0)
    return (torch.where(ok, wd / tot, 0.5), torch.where(ok, ws / tot, 0.5))


def _phong_exponent(r):
    return torch.clamp_min(2.0 / r - 2.0, 0.0)


def _rational_g1(a):
    return (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)


def _smith_g1(w, n, r):
    """Walter et al.'s rational approximation of Smith's G1 for a
    Beckmann-like lobe of roughness r; 1 where a = 1/(sqrt(r) tan) >= 1.6.
    At grazing (cos^2 <= 1e-12, where 1/cos^2 - 1 loses the 1) a is
    |cos| / sqrt(r) to float precision, and G1 falls to 0 with it, as the
    published formula does; it is never 1 there."""
    c = _dot(w, n)
    c2 = c ** 2
    tan = _sqrt0(torch.where(c2 > 1e-12, 1.0 / torch.where(c2 > 1e-12, c2,
                                                           1.0) - 1.0, 0.0))
    den = _sqrt0(r) * tan
    big = den > 1e-12
    a = torch.where(big, 1.0 / torch.where(big, den, 1.0), 1e12)
    a = torch.clamp_max(a, 1.6)
    g = _rational_g1(a)
    one = (tan == 0) | ~big | (1.0 / den.clamp_min(1e-12) >= 1.6)
    a_graze = torch.clamp_max(c.abs() / _sqrt0(r).clamp_min(1e-30), 1.6)
    g_graze = torch.where(a_graze >= 1.6, 1.0, _rational_g1(a_graze))
    return torch.where(c2 <= 1e-12, g_graze, torch.where(one, 1.0, g))


def _oriented_ng(h):
    return torch.where((_dot(h.ng, h.fn) < 0)[:, None], -h.ng, h.ng)


def bsdf(mat, h, wi, wo, min_rough):
    """f(wi, wo) |cos(fn, wo)|: Lambert plus Blinn-Phong microfacet."""
    ng = _oriented_ng(h)
    gi, go = _dot(ng, wi), _dot(ng, wo)
    si, so = _dot(h.fn, wi).abs(), _dot(h.fn, wo).abs()
    alive = ((gi * go >= 0) & ~((gi < 0) & (go < 0))
             & (si > 0) & (so > 1e-3) & (go.abs() > 1e-3))
    r = torch.maximum(mat.rough, min_rough)
    diff = mat.kd * (so / math.pi)[:, None]
    m = _unit(wi + wo)
    mz = _dot(h.fn, m)
    e = _phong_exponent(r.clamp_min(1e-12))
    D = _pow0(mz.clamp_min(0.0), e) * (e + 2.0) / (2.0 * math.pi)
    G = _smith_g1(wi, h.fn, r) * _smith_g1(wo, h.fn, r)
    F = mat.ks + (1.0 - mat.ks) * _pow0(
        (1.0 - _dot(m, wo).abs()).clamp_min(0.0), 5.0)[:, None]
    spec = F * (D * G / (4.0 * si.clamp_min(1e-12)))[:, None]
    spec = torch.where((mz > 0)[:, None] & mat.spec_on[:, None], spec, 0.0)
    return torch.where(alive[:, None], diff + spec, 0.0)


def bsdf_pdf(mat, h, wi, wo, min_rough):
    """Solid-angle density of bsdf_sample's direction wo."""
    ng = _oriented_ng(h)
    gi, go = _dot(ng, wi), _dot(ng, wo)
    alive = (gi * go >= 0) & ~((gi < 0) & (go < 0))
    pd, ps = _lobe_pmfs(mat)
    so = _dot(h.fn, wo).abs()
    m = _unit(wi + wo)
    mz = _dot(h.fn, m)
    mo = _dot(m, wo).abs()
    r = torch.maximum(mat.rough, min_rough).clamp_min(1e-6)
    e = _phong_exponent(r)
    D = _pow0(mz.clamp_min(0.0), e) * (e + 2.0) / (2.0 * math.pi)
    spec = ps * D * mz / (4.0 * mo.clamp_min(1e-12))
    spec = torch.where((mz > 0) & (mo > 0) & (ps > 0), spec, 0.0)
    pdf = torch.where(pd > 0, pd * so / math.pi, 0.0) + spec
    return torch.where(alive, pdf, 0.0)


def _to_world(h, v):
    return h.fx * v[:, 0:1] + h.fy * v[:, 1:2] + h.fn * v[:, 2:3]


def bsdf_sample(mat, h, wi, u, min_rough):
    """A direction from the diffuse lobe (cosine-weighted) with the diffuse
    lobe's luminance share, else from the Blinn-Phong normal distribution,
    mirrored into the incoming side's hemisphere.  Returns (wo, the next
    bounce's minimum roughness); wo = 0 where the surface is seen from
    behind."""
    ng = _oriented_ng(h)
    gi = _dot(ng, wi)
    alive = gi >= 0
    pd, _ = _lobe_pmfs(mat)
    diffuse = u[:, 0] <= pd
    phi = 2.0 * math.pi * u[:, 1]
    rxy = _sqrt0(1.0 - u[:, 2])
    cos_dir = torch.stack([torch.cos(phi) * rxy, torch.sin(phi) * rxy,
                           _sqrt0(u[:, 2])], -1)
    wd = _to_world(h, cos_dir)
    flip = (_dot(ng, wd) * gi < 0)[:, None]
    wd = torch.where(flip, _to_world(h, -cos_dir), wd)
    r = torch.maximum(mat.rough, min_rough).clamp_min(1e-6)
    e = _phong_exponent(r)
    cos_t = _pow0(u[:, 1].clamp_min(1e-20), 1.0 / (e + 2.0))
    sin_t = _sqrt0(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u[:, 2]
    ml = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                      cos_t], -1)

    def mirror(m):
        return 2.0 * _dot(wi, m)[:, None] * m - wi

    ws = mirror(_to_world(h, ml))
    flip = (_dot(ng, ws) * gi < 0)[:, None]
    ws = torch.where(flip, mirror(_to_world(h, -ml)), ws)
    wo = torch.where(diffuse[:, None], wd, ws)
    wo = torch.where(alive[:, None], wo, 0.0)
    nxt = torch.where(diffuse, torch.ones_like(r), torch.maximum(r, min_rough))
    return wo, torch.where(alive, nxt, min_rough)


@dataclass
class Lights:
    """The area lights' sampling tables (all detached but the emission)."""
    mesh: list  # mesh id of each light
    pmf: torch.Tensor  # (L,) by power
    area: torch.Tensor  # (L,)
    tri_cdf: list  # per light, exclusive area CDF over its triangles


def light_tables(scene):
    meshes, powers, areas, cdfs = [], [], [], []
    for i, m in enumerate(scene.meshes):
        if m.emission is None:
            continue
        v = m.vertices.detach()
        f = m.faces
        a = 0.5 * torch.linalg.vector_norm(
            _cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), dim=-1)
        tot = a.sum()
        meshes.append(i)
        areas.append(tot)
        powers.append(tot * _lum(m.emission.detach()) * math.pi)
        cdfs.append((torch.cumsum(a, 0) - a) / tot.clamp_min(1e-20))
    p = torch.stack(powers)
    return Lights(meshes, p / p.sum().clamp_min(1e-20), torch.stack(areas),
                  cdfs)


def _pick(cdf, u):
    """The last entry of an exclusive CDF at or below u."""
    return ((cdf[None, :] <= u[:, None]).sum(-1) - 1).clamp(0, cdf.shape[0] - 1)


def sample_light(scene, lights, u):
    """A point on an area light: the light by power, its triangle by area,
    the point uniform on the triangle.  Returns (light index, point,
    unit normal), all detached: the light's geometry takes no gradient
    through its samples."""
    n = u.shape[0]
    dev = u.device
    li = _pick(torch.cumsum(lights.pmf, 0) - lights.pmf, u[:, 0])
    pos = torch.zeros((n, 3), device=dev)
    nrm = torch.zeros((n, 3), device=dev)
    for k, mi in enumerate(lights.mesh):
        m = scene.meshes[mi]
        sel = li == k
        tri = m.faces[_pick(lights.tri_cdf[k], u[:, 1])]
        v = m.vertices.detach()
        a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
        su = torch.sqrt(u[:, 2].clamp(0.0, 1.0))
        b1, b2 = 1.0 - su, su * u[:, 3]
        p = a + (b - a) * b1[:, None] + (c - a) * b2[:, None]
        pos = torch.where(sel[:, None], p, pos)
        nrm = torch.where(sel[:, None], _unit(_cross(b - a, c - a)), nrm)
    return li, pos, nrm


def _emission(fl, mesh_ids, facing):
    """Emitted radiance of hit faces that face the viewer (one-sided)."""
    out = torch.zeros(mesh_ids.shape + (3,), device=mesh_ids.device)
    for i, m in enumerate(fl.meshes):
        if m.emission is not None:
            out = torch.where(((mesh_ids == i) & facing)[:, None],
                              m.emission, out)
    return out


def _mis(a, b):
    """Power heuristic weight of the strategy with density a against b."""
    r = torch.where(a > 0, b / torch.where(a > 0, a, 1.0), 0.0)
    return 1.0 / (1.0 + r * r)


# ----------------------------------------------------------------------
# The path tracer
# ----------------------------------------------------------------------

def trace(scene, fl, lights, seed, pixel, sample, max_bounces):
    """(lanes, 3) radiance of one path per (pixel, sample) lane."""
    org, d = camera_rays(scene.camera, pixel,
                         uniforms(seed, pixel, sample, 0, 2))
    return trace_rays(scene, fl, lights, seed, pixel, sample, max_bounces,
                      org, d)


def trace_rays(scene, fl, lights, seed, pixel, sample, max_bounces, org, d):
    """(lanes, 3) radiance of paths that start with the rays (org, d),
    their random numbers keyed by (seed, pixel, sample) from dim 2 on."""
    n = pixel.shape[0]
    dev = pixel.device
    out = torch.zeros((n, 3), device=dev)
    tri = closest_hit(fl, org.detach(), d.detach(),
                      torch.zeros(n, device=dev),
                      torch.full((n,), math.inf, device=dev))
    lane = torch.nonzero(tri >= 0)[:, 0]
    h = surface(fl, tri[lane], org[lane], d[lane])
    wi = -d[lane]
    out = out.index_add(0, lane, _emission(fl, h.mesh, _dot(wi, h.fn) > 0))
    thr = torch.ones((lane.shape[0], 3), device=dev)
    min_rough = torch.zeros(lane.shape[0], device=dev)
    for bounce in range(max_bounces):
        dim = 2 + 7 * bounce
        mat = materials(fl, h.mesh)
        ul = uniforms(seed, pixel[lane], sample[lane], dim, 4)
        ub = uniforms(seed, pixel[lane], sample[lane], dim + 4, 3)
        contrib = torch.zeros_like(thr)
        # Next-event estimation.
        li, lp, ln = sample_light(scene, lights, ul)
        to_l = lp - h.pos
        dist2 = _dot(to_l, to_l)
        wl = _unit(to_l)
        blocked = any_hit(fl, h.pos.detach(), wl.detach(),
                          torch.full_like(dist2, TMIN_SECONDARY),
                          (1.0 - 1e-3) * dist2.detach().sqrt())
        cos_l = _dot(wl, ln).abs()
        geo = torch.where(dist2 > 0, cos_l / torch.where(dist2 > 0, dist2,
                                                         1.0), 0.0)
        p_light = lights.pmf[li] / lights.area[li]
        p_bsdf = bsdf_pdf(mat, h, wi, wl, min_rough) * geo
        emit = torch.stack([scene.meshes[mi].emission
                            for mi in lights.mesh])[li]
        ok = ((dist2 > 1e-20) & (_dot(-wl, ln) > 0) & (p_light > 0)
              & ~blocked)
        nee = ((_mis(p_light, p_bsdf) * geo / p_light)[:, None]
               * bsdf(mat, h, wi, wl, min_rough) * emit)
        contrib = contrib + torch.where(ok[:, None], nee, 0.0)
        # BSDF sampling.
        wo, next_rough = bsdf_sample(mat, h, wi, ub, min_rough)
        tri2 = closest_hit(fl, h.pos.detach(), wo.detach(),
                           torch.full_like(dist2, TMIN_SECONDARY),
                           torch.full_like(dist2, math.inf))
        k = torch.nonzero(tri2 >= 0)[:, 0]
        h2 = surface(fl, tri2[k], h.pos[k], wo[k])
        to_h = h2.pos - h.pos[k]
        dist2 = _dot(to_h, to_h)
        ok = dist2 > 1e-20
        w = _unit(torch.where(ok[:, None], to_h, to_h.new_tensor(
            [0.0, 0.0, 1.0])))
        sub = Mat(mat.kd[k], mat.ks[k], mat.rough[k], mat.spec_on[k])
        hk = Hit(h.pos[k], h.ng[k], h.fx[k], h.fy[k], h.fn[k], h.mesh[k])
        pdf = bsdf_pdf(sub, hk, wi[k], w, min_rough[k])
        ok = ok & (pdf > 1e-20)
        f = bsdf(sub, hk, wi[k], w, min_rough[k])
        inv_pdf = torch.where(ok, 1.0 / torch.where(ok, pdf, 1.0), 0.0)
        facing = _dot(-w, h2.fn) > 0
        le = _emission(fl, h2.mesh, facing)
        is_light = torch.zeros_like(ok)
        p_light = torch.zeros_like(pdf)
        for j, mi in enumerate(lights.mesh):
            sel = (h2.mesh == mi) & facing
            is_light = is_light | sel
            geo2 = _dot(w, h2.ng).abs() / torch.where(ok, dist2, 1.0)
            pl = torch.where(geo2 > 0, (lights.pmf[j] / lights.area[j])
                             / torch.where(geo2 > 0, geo2, 1.0), 0.0)
            p_light = torch.where(sel, pl, p_light)
        hit_l = (_mis(pdf, p_light) * inv_pdf)[:, None] * f * le
        contrib = contrib.index_add(
            0, k, torch.where((ok & is_light)[:, None], hit_l, 0.0))
        out = out.index_add(0, lane, thr * contrib)
        if bounce + 1 >= max_bounces:
            break
        # Continue the path from the BSDF sample's hit.
        thr = thr[k] * torch.where(ok[:, None], f * inv_pdf[:, None], 0.0)
        live = thr.abs().amax(-1) > 0
        k, h2, thr = k[live], _take(h2, live), thr[live]
        wi = -wo[k]
        min_rough = next_rough[k]
        lane, h = lane[k], h2
    return out


def _take(h, sel):
    return Hit(*(getattr(h, f)[sel] for f in
                 ("pos", "ng", "fx", "fy", "fn", "mesh")))


def render(scene, spp, seed, max_bounces=1):
    """(height, width, 3) image: the mean of spp paths a pixel, each path
    keyed by (seed, pixel, sample)."""
    cam = scene.camera
    npix = cam.height * cam.width
    dev = cam.position.device
    fl = flatten(scene)
    lights = light_tables(scene)
    img = torch.zeros((npix, 3), device=dev)
    lanes = torch.arange(npix * spp, device=dev)
    for a in range(0, lanes.shape[0], LANES):
        lane = lanes[a:a + LANES]
        pixel, sample = lane % npix, lane // npix
        img = img.index_add(0, pixel, trace(scene, fl, lights, seed, pixel,
                                            sample, max_bounces))
    return (img / spp).reshape(cam.height, cam.width, 3)


def translated(scene, mesh, offset):
    """The scene with mesh `mesh` moved by `offset` (its normals kept)."""
    meshes = list(scene.meshes)
    meshes[mesh] = replace(meshes[mesh],
                           vertices=meshes[mesh].vertices + offset)
    return replace(scene, meshes=meshes)
