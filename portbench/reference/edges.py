"""The edge terms of the plain reference: the parts of the gradient that
autograd through plain.py leaves out, where visibility jumps.  Written
from Li et al. 2018, "Differentiable Monte Carlo Ray Tracing through Edge
Sampling" (section 4, primary edges on the screen; section 5, secondary
edges seen from the shading points), not from the port's code: no
resampling, no clusters, no Morton order and no firefly clamp.

Both terms are surrogates  sum_s w_s <n_s, x_s(theta)>: w (the jump of
the integrand across the edge, times its adjoint, over the sample's
density) and the edge normal n are detached, x is the edge point as a
function of the scene, so that autograd of the loss plus the surrogate
gives the interior and the edge gradient in one pass.

Primary: the silhouettes seen from the camera (boundary edges, and edges
whose two faces face opposite sides of it), projected, clipped to the
image and sampled stratified by clipped screen length; each sample's two
sides are plain's paths from camera rays through the point moved 1e-5 of
the screen's width along the edge normal, the jump weighted by the
adjoint of the pixel that holds the point.

Secondary (direct lighting, max_bounces 1): at each shading point of a
camera path the integrand f(w) Le(w) jumps where an occluder's silhouette
crosses the light and at the light's rim.  The candidates are found by
brute force over every edge in blocks (a silhouette from the point,
within the light's cone from it, in front of the light), clipped to
each light triangle's cone, and sampled stratified by subtended angle.
The pair of rays 1e-5 radians either side traces the jump.  The motion
of the discontinuity counts relative to what each sampling strategy of
plain.py holds fixed while autograd differentiates it: the light point
for next-event estimation (so an occluder's edge moves against the light
point behind it, and the rim not at all), the sample's uniforms for BSDF
sampling (so the rim and occluders move against the direction that the
shading frame and the incoming direction turn), each with its share of
the power-heuristic weight.

Random numbers: plain's PCG4D stream at seeds of its own (SEED_OFFSET).
It imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from portbench.reference import plain
from portbench.reference.plain import _cross, _dot, _unit

SEED_OFFSET = 0x2545F491  # the edge terms' stream, past every path seed
PRIMARY_OFFSET = 1e-5  # of the screen's width, either side of the edge
SECONDARY_OFFSET = 1e-5  # radians, either side of the edge
PRIMARY_PER_LANE = 1  # primary edge samples per camera lane (pixel x spp)
SECONDARY_PER_POINT = 4  # edge samples per shading point
SPLIT = 4  # parts of each candidate piece, weighed apart
COPLANAR = 1e-6  # faces whose normals' dot is above 1 - COPLANAR: no edge
WELD = 1e-5  # vertices that round to one point of this grid are welded
NEAR = 1e-4  # the camera's near clip, along its view axis
PAIRS = 1 << 24  # shading points x edges per block of the edge search


@dataclass
class Topology:
    """The unique edges of every mesh, vertices welded: flat vertex ids
    (into all meshes' vertices in order), their faces (flat ids, f1 = -1
    on a boundary), and whether the edge is an emitter's."""
    v0: torch.Tensor
    v1: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor
    light: torch.Tensor
    faces: torch.Tensor  # (F, 3) flat vertex ids


def topology(scene):
    """The edge graph of the scene's meshes (fixed by the faces: build it
    once, use it at any pose)."""
    dev = scene.camera.position.device
    canon, faces, light_face, first = [], [], [], 0
    for m in scene.meshes:
        v = m.vertices.detach()
        key = torch.round(v / WELD).to(torch.int64)
        _, inv = torch.unique(key, dim=0, return_inverse=True)
        rep = torch.full((int(inv.max()) + 1,), v.shape[0], dtype=torch.int64,
                         device=dev).scatter_reduce(
            0, inv, torch.arange(v.shape[0], device=dev), "amin")
        canon.append(rep[inv] + first)
        faces.append(m.faces + first)
        light_face.append(torch.full((m.faces.shape[0],),
                                     m.emission is not None, device=dev))
        first += v.shape[0]
    canon, faces = torch.cat(canon), torch.cat(faces)
    light_face = torch.cat(light_face)
    F = faces.shape[0]
    a = canon[faces[:, [0, 1, 2]].T.reshape(-1)]
    b = canon[faces[:, [1, 2, 0]].T.reshape(-1)]
    fid = torch.arange(F, device=dev).repeat(3)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    keep = lo != hi
    lo, hi, fid = lo[keep], hi[keep], fid[keep]
    order = torch.argsort(lo * first + hi, stable=True)
    lo, hi, fid = lo[order], hi[order], fid[order]
    same_prev = torch.zeros_like(keep[:lo.shape[0]])
    same_prev[1:] = (lo[1:] == lo[:-1]) & (hi[1:] == hi[:-1])
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    f1 = torch.where(same_next, torch.roll(fid, -1), -1)
    first_of = ~same_prev
    return Topology(lo[first_of], hi[first_of], fid[first_of], f1[first_of],
                    light_face[fid[first_of]], faces)


def vertices(scene):
    """All meshes' vertices in order, as the scene holds them."""
    return torch.cat([m.vertices for m in scene.meshes])


def _face_normals(v, faces):
    return _unit(_cross(v[faces[:, 1]] - v[faces[:, 0]],
                        v[faces[:, 2]] - v[faces[:, 0]]))


def _silhouette(front0, front1, topo, coplanar):
    boundary = topo.f1 < 0
    return boundary | ((front0 != front1) & ~coplanar)


def _edge_normals(v, topo):
    """Detached unit normals of each edge's two faces, and whether they
    are coplanar."""
    fn = _face_normals(v, topo.faces)
    n0 = fn[topo.f0]
    n1 = fn[topo.f1.clamp_min(0)]
    cop = (_dot(n0, n1) >= 1.0 - COPLANAR) & (topo.f1 >= 0)
    return n0, n1, cop


# ----------------------------------------------------------------------
# Primary edges
# ----------------------------------------------------------------------

def _frame(cam):
    fwd = _unit(cam.look_at - cam.position)
    right = _unit(_cross(fwd, _unit(cam.up)))
    up = _unit(_cross(right, fwd))
    return fwd, right, up


def project(cam, x):
    """(..., 2) pixel coordinates of world points x (x right, y down) under
    plain.camera_rays' pinhole, and their depth along the view axis;
    differentiable in the camera and in x."""
    fwd, right, up = _frame(cam)
    q = x - cam.position
    z = _dot(q, fwd)
    tan_half = math.tan(math.radians(0.5 * cam.fov_deg))
    W, H = cam.width, cam.height
    sx = _dot(q, right) / z / (2.0 * tan_half) + 0.5
    sy = 0.5 - _dot(q, up) / z * W / (2.0 * H * tan_half)
    return torch.stack([sx * W, sy * H], -1), z


def _clip_box(pa, pb, W, H):
    """Liang-Barsky: the parameter range of segments pa -> pb inside
    [0, W] x [0, H]."""
    t0 = torch.zeros_like(pa[:, 0])
    t1 = torch.ones_like(pa[:, 0])
    ok = torch.ones_like(t0, dtype=torch.bool)
    d = pb - pa
    for ax, lim in ((0, W), (1, H)):
        dd, pp = d[:, ax], pa[:, ax]
        flat = dd == 0
        safe = torch.where(flat, 1.0, dd)
        lo, hi = (0.0 - pp) / safe, (lim - pp) / safe
        t0 = torch.where(flat, t0, torch.maximum(t0, torch.minimum(lo, hi)))
        t1 = torch.where(flat, t1, torch.minimum(t1, torch.maximum(lo, hi)))
        ok = ok & (~flat | ((pp >= 0) & (pp <= lim)))
    return t0, t1, ok & (t1 > t0)


def primary(scene, fl, lights, topo, adj, spp, seed, max_bounces):
    """The primary edge surrogate of an image whose adjoint is adj
    (H, W, 3)."""
    s = primary_samples(scene, fl, lights, topo, adj, spp, seed, max_bounces)
    if s is None:
        return torch.zeros((), device=scene.camera.position.device)
    w, nrm, e, tau, ta, tb = s
    cam, v = scene.camera, vertices(scene)
    a3 = v[topo.v0[e]] + ta[e, None] * (v[topo.v1[e]] - v[topo.v0[e]])
    b3 = v[topo.v0[e]] + tb[e, None] * (v[topo.v1[e]] - v[topo.v0[e]])
    x = ((1 - tau)[:, None] * project(cam, a3)[0]
         + tau[:, None] * project(cam, b3)[0])
    return (w * _dot(nrm, x)).sum()


@torch.no_grad()
def primary_samples(scene, fl, lights, topo, adj, spp, seed, max_bounces):
    """The primary samples' weights (jump x adjoint / density), screen
    normals, edges, chord parameters and near-clip parameters; None where
    no silhouette is on the screen."""
    cam = scene.camera
    H, W = cam.height, cam.width
    dev = cam.position.device
    v = vertices(scene)
    seed_e = (int(seed) + SEED_OFFSET) & plain.M32
    n = PRIMARY_PER_LANE * H * W * spp
    vd = v.detach()
    a, b = vd[topo.v0], vd[topo.v1]
    n0, n1, cop = _edge_normals(vd, topo)
    c = cam.position.detach()
    sil = _silhouette(_dot(n0, c - a) > 0, _dot(n1, c - a) > 0, topo,
                      cop)
    fwd = _frame(cam)[0].detach()
    za, zb = _dot(a - c, fwd), _dot(b - c, fwd)
    front = (za > NEAR) | (zb > NEAR)
    dz = torch.where(zb == za, 1.0, zb - za)
    ta = torch.where(za > NEAR, 0.0, (NEAR - za) / dz)
    tb = torch.where(zb > NEAR, 1.0, (NEAR - za) / dz)
    pa = project(cam, a + ta[:, None] * (b - a))[0].detach()
    pb = project(cam, a + tb[:, None] * (b - a))[0].detach()
    t0, t1, inside = _clip_box(pa, pb, W, H)
    length = torch.where(sil & front & inside,
                         torch.linalg.vector_norm(pb - pa, dim=-1)
                         * (t1 - t0), 0.0)
    cum = torch.cumsum(length.double(), 0)
    total = float(cum[-1])
    if total <= 0 or n == 0:
        return None
    i = torch.arange(n, device=dev)
    u = plain.uniforms(seed_e, i, torch.ones_like(i), 0, 2).double()
    s = (i.double() + u[:, 0]) / n * total
    e = torch.searchsorted(cum, s, right=True).clamp_max(
        cum.shape[0] - 1)
    frac = ((s - (cum[e] - length[e].double()))
            / length[e].double().clamp_min(1e-30)).clamp(0, 1).float()
    tau = t0[e] + (t1[e] - t0[e]) * frac
    e_dir = _unit(pb[e] - pa[e])
    nrm = torch.stack([-e_dir[:, 1], e_dir[:, 0]], -1)
    xs = (1 - tau)[:, None] * pa[e] + tau[:, None] * pb[e]
    off = PRIMARY_OFFSET * W
    jump = torch.zeros((n, 3), device=dev)
    for lo in range(0, n, plain.LANES // 2):
        sl = slice(lo, lo + plain.LANES // 2)
        pts = torch.cat([xs[sl] + off * nrm[sl], xs[sl] - off * nrm[sl]])
        px = pts[:, 0].floor().clamp(0, W - 1)
        py = pts[:, 1].floor().clamp(0, H - 1)
        org, d = plain.camera_rays(
            cam, (py * W + px).long(),
            torch.stack([pts[:, 0] - px, pts[:, 1] - py], -1))
        key = i[sl].repeat(2)
        rad = plain.trace_rays(scene, fl, lights, seed_e, key,
                               torch.zeros_like(key), max_bounces, org, d)
        m = rad.shape[0] // 2
        jump[sl] = rad[m:] - rad[:m]  # minus side less plus side
    px = xs[:, 0].floor().long().clamp(0, W - 1)
    py = xs[:, 1].floor().long().clamp(0, H - 1)
    w = (jump * adj.detach()[py, px]).sum(-1) * (total / n)
    return w, nrm, e, tau, ta, tb


# ----------------------------------------------------------------------
# Secondary edges
# ----------------------------------------------------------------------

@dataclass
class _Light:
    mesh: int  # mesh id
    k: int  # index in plain's light tables
    tris: torch.Tensor  # (T, 3, 3) detached corners
    normal: torch.Tensor  # (T, 3) emitting side
    center: torch.Tensor  # bounding sphere
    radius: torch.Tensor


def _lights(scene, lights):
    out = []
    for k, mi in enumerate(lights.mesh):
        m = scene.meshes[mi]
        v = m.vertices.detach()
        tris = v[m.faces]
        c = 0.5 * (v.amin(0) + v.amax(0))
        out.append(_Light(mi, k, tris, _unit(_cross(
            tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])), c,
            torch.linalg.vector_norm(v - c, dim=-1).amax()))
    return out


def _candidates(p, a, b, n0, n1, cop, topo, occ, rims, light):
    """Edge pieces seen from shading points p (P, 3) within `light`:
    (point index, edge id, t0, t1) of the occluders' silhouettes clipped
    to each light triangle's cone and to the near side of its plane, and
    the light's rim edges whole where the point sees its emitting side."""
    dev = p.device
    # Coarse: an occluder edge's bounding sphere must meet the cone from p
    # around the light's bounding sphere, and the edge be a silhouette.
    oid = torch.nonzero(occ)[:, 0]
    oa, ob = a[oid], b[oid]
    mid = 0.5 * (oa + ob)
    rad = 0.5 * torch.linalg.vector_norm(ob - oa, dim=-1)
    on0, on1, ocop = n0[oid], n1[oid], cop[oid]
    obound = topo.f1[oid] < 0
    c0, c1, mm = _dot(on0, oa), _dot(on1, oa), _dot(mid, mid)
    step = max(1, PAIRS // max(oid.shape[0], 1))
    pis, eis = [], []
    for lo in range(0, p.shape[0], step):
        q = p[lo:lo + step]
        to_l = light.center - q
        D = torch.linalg.vector_norm(to_l, dim=-1)
        ax = to_l / D[:, None]
        sin_a = (light.radius / D).clamp_max(1.0)
        cos_a = torch.sqrt(1.0 - sin_a ** 2)
        proj = mid @ ax.T - _dot(q, ax)[None, :]  # (E, Pb)
        dist = torch.sqrt((mm[:, None] - 2.0 * (mid @ q.T)
                           + _dot(q, q)[None, :]).clamp_min(1e-20))
        sin_b = (rad[:, None] / dist).clamp_max(1.0)
        cos_ab = (cos_a[None, :] * torch.sqrt(1.0 - sin_b ** 2)
                  - sin_a[None, :] * sin_b)
        near = ((proj >= cos_ab * dist) & (proj > -rad[:, None])
                & (proj < (D + light.radius)[None, :] + rad[:, None]))
        sil = obound[:, None] | (((on0 @ q.T) > c0[:, None])
                                 != ((on1 @ q.T) > c1[:, None])) \
            & ~ocop[:, None]
        ei, pi = torch.nonzero(near & sil, as_tuple=True)
        pis.append(pi + lo)
        eis.append(oid[ei])
    pi, ei = torch.cat(pis), torch.cat(eis)
    out = []
    for tri, nl in zip(light.tris, light.normal):
        q, ea, eb = p[pi], a[ei], b[ei]
        lo = torch.zeros_like(q[:, 0])
        hi = torch.ones_like(lo)
        side = _dot(nl, q - tri[0])
        planes = []
        for i in range(3):  # through p and each side of the triangle
            nrm = _cross(tri[i] - q, tri[(i + 1) % 3] - q)
            inward = _dot(nrm, tri[(i + 2) % 3] - q) > 0
            planes.append((nrm * torch.where(inward, 1.0, -1.0)[:, None], q))
        # ... and the light's own plane, from p's side.
        planes.append((nl * torch.where(side > 0, 1.0, -1.0)[:, None],
                       tri[0]))
        for nrm, org in planes:
            sa, sb = _dot(nrm, ea - org), _dot(nrm, eb - org)
            tc = sa / torch.where(sa == sb, 1.0, sa - sb)
            lo = torch.where((sa < 0) & (sb >= 0), torch.maximum(lo, tc), lo)
            hi = torch.where((sa >= 0) & (sb < 0), torch.minimum(hi, tc), hi)
            hi = torch.where((sa < 0) & (sb < 0), lo, hi)
        ok = (side > 0) & (hi > lo)
        out.append((pi[ok], ei[ok], lo[ok], hi[ok]))
    # The rim: the emitter's boundary edges, whole, from its emitting side.
    rid = torch.nonzero(rims)[:, 0]
    front = (p @ n0[rid].T) > _dot(n0[rid], a[rid])[None, :]
    rp, rr = torch.nonzero(front, as_tuple=True)
    out.append((rp, rid[rr], torch.zeros(rp.shape[0], device=dev),
                torch.ones(rp.shape[0], device=dev)))
    return tuple(torch.cat(x) for x in zip(*out))


def _angle(u, v):
    return torch.atan2(torch.linalg.vector_norm(_cross(u, v), dim=-1),
                       _dot(u, v))


def _sub(h, ix):
    return plain.Hit(*(getattr(h, f)[ix] for f in
                       ("pos", "ng", "fx", "fy", "fn", "mesh")))


def _detached(h):
    return plain.Hit(*(getattr(h, f).detach() for f in
                       ("pos", "ng", "fx", "fy", "fn", "mesh")))


def secondary(scene, fl, lights, topo, adj, spp, seed, max_bounces):
    """The secondary edge surrogate of an image whose adjoint is adj
    (H, W, 3): spp camera paths a pixel, SECONDARY_PER_POINT edge samples
    at each one's first hit."""
    if max_bounces != 1:
        raise NotImplementedError(
            "the reference models secondary edges of direct lighting only "
            f"(max_bounces 1), not of {max_bounces} bounces")
    K = SECONDARY_PER_POINT
    cam = scene.camera
    H, W = cam.height, cam.width
    dev = cam.position.device
    npix = H * W
    seed_s = (int(seed) + SEED_OFFSET + 1) & plain.M32
    v = vertices(scene)
    vd = v.detach()
    a, b = vd[topo.v0], vd[topo.v1]
    n0, n1, cop = _edge_normals(vd, topo)
    adj_flat = adj.detach().reshape(-1, 3) / spp
    total = torch.zeros((), device=dev)
    occ = ~topo.light
    mesh_of_v = torch.cat([torch.full((m.vertices.shape[0],), i, device=dev)
                           for i, m in enumerate(scene.meshes)])
    for light in _lights(scene, lights):
        rims = topo.light & (topo.f1 < 0) & (mesh_of_v[topo.v0] == light.mesh)
        lanes = torch.arange(npix * spp, device=dev)
        for lo in range(0, lanes.shape[0], plain.LANES):
            lane = lanes[lo:lo + plain.LANES]
            pixel, sample = lane % npix, lane // npix
            org, d = plain.camera_rays(cam, pixel, plain.uniforms(
                seed_s, pixel, sample, 0, 2))
            tri = plain.closest_hit(fl, org.detach(), d.detach(),
                                    torch.zeros(lane.shape[0], device=dev),
                                    torch.full((lane.shape[0],), math.inf,
                                               device=dev))
            hit = torch.nonzero(tri >= 0)[:, 0]
            if hit.numel() == 0:
                continue
            h = plain.surface(fl, tri[hit], org[hit], d[hit])
            hd = _detached(h)
            with torch.no_grad():
                pi, ei, t0, t1 = _candidates(hd.pos, a, b, n0, n1, cop, topo,
                                             occ, rims, light)
            if pi.numel() == 0:
                continue
            total = total + _point_samples(
                scene, fl, lights, light, h, hd, -d[hit], pixel[hit],
                sample[hit], adj_flat, v, topo, a, b, pi, ei, t0, t1, K,
                seed_s)
    return total


def _importance(fl, lights, light, hd, wi, a, b, topo, pi, ei, t0, t1):
    """A positive weight of each candidate piece, near its share of the
    gradient: its subtended angle times the BSDF toward its middle over
    the distance, and on the rim times the BSDF strategy's share (the only
    one that the rim moves against).  Any positive weight is unbiased."""
    q = hd.pos[pi]
    xa = a[ei] + t0[:, None] * (b[ei] - a[ei])
    xb = a[ei] + t1[:, None] * (b[ei] - a[ei])
    wa, wb = _unit(xa - q), _unit(xb - q)
    mid = 0.5 * (xa + xb) - q
    dist = torch.linalg.vector_norm(mid, dim=-1).clamp_min(1e-12)
    wm = mid / dist[:, None]
    h = _sub(hd, pi)
    mat = plain.materials(fl, hd.mesh[pi])
    zero = torch.zeros_like(dist)
    f = plain._lum(plain.bsdf(mat, h, wi[pi], wm, zero))
    geo = _dot(wm, light.normal[0]).abs() / (dist * dist)
    w_b = 1.0 - plain._mis((lights.pmf[light.k] / lights.area[light.k])
                           .expand_as(dist),
                           plain.bsdf_pdf(mat, h, wi[pi], wm, zero) * geo)
    share = torch.where(topo.light[ei], w_b + 0.01, 1.0)
    return _angle(wa, wb) * (f + 1e-4) * share / dist


def _point_samples(scene, fl, lights, light, h, hd, wi, pixel, sample,
                   adj_flat, v, topo, a, b, pi, ei, t0, t1, K, seed_s):
    """K samples a shading point over its candidate pieces (each cut in
    SPLIT), stratified by _importance; the pair traces and the
    surrogate."""
    dev = pi.device
    with torch.no_grad():
        part = torch.arange(SPLIT, device=dev).repeat(pi.shape[0])
        pi, ei = pi.repeat_interleave(SPLIT), ei.repeat_interleave(SPLIT)
        t0, t1 = t0.repeat_interleave(SPLIT), t1.repeat_interleave(SPLIT)
        t0, t1 = (t0 + (t1 - t0) * part / SPLIT,
                  t0 + (t1 - t0) * (part + 1) / SPLIT)
        order = torch.argsort(pi, stable=True)
        pi, ei, t0, t1 = pi[order], ei[order], t0[order], t1[order]
        wt = _importance(fl, lights, light, hd, wi.detach(), a, b, topo, pi,
                         ei, t0, t1).double()
        P = hd.pos.shape[0]
        A = torch.zeros(P, dtype=torch.float64, device=dev).index_add_(
            0, pi, wt)
        count = torch.bincount(pi, minlength=P)
        first = torch.cumsum(count, 0) - count
        cum = torch.cumsum(wt, 0)
        pts = torch.nonzero((count > 0) & (A > 0))[:, 0]
        pts = pts.repeat_interleave(K)
        k = torch.arange(K, device=dev).repeat(pts.shape[0] // K)
        u = plain.uniforms(seed_s, pixel[pts], sample[pts], 2, 1)
        z = plain.uniforms(seed_s, pixel[pts], sample[pts], 3, K)
        z = z.gather(1, k[:, None])[:, 0]  # the point along the piece
        key = (cum[first[pts]] - wt[first[pts]]
               + (k.double() + u[:, 0].double()) / K * A[pts])
        c = torch.searchsorted(cum, key, right=True)
        c = torch.minimum(torch.maximum(c, first[pts]),
                          first[pts] + count[pts] - 1)
        e, j = ei[c], pts
        tau = t0[c] + (t1[c] - t0[c]) * z
        inv_pdf = (A[pts] * (t1[c] - t0[c]).double()
                   / (K * wt[c]).clamp_min(1e-300)).float()
        ea, eb = a[e], b[e]
        p = hd.pos[j]
        x = ea + tau[:, None] * (eb - ea)
        to_x = x - p
        dist = torch.linalg.vector_norm(to_x, dim=-1).clamp_min(1e-12)
        w = to_x / dist[:, None]
        dwdt = ((eb - ea) - w * _dot(w, eb - ea)[:, None]) / dist[:, None]
        speed = torch.linalg.vector_norm(dwdt, dim=-1)
        nrm = _unit(_cross(w, _unit(dwdt)))
        wp = _unit(w + SECONDARY_OFFSET * nrm)
        wm = _unit(w - SECONDARY_OFFSET * nrm)
        S = j.shape[0]
        o2 = torch.cat([p, p])
        w2 = torch.cat([wp, wm])
        tri = plain.closest_hit(fl, o2, w2,
                                torch.full((2 * S,), plain.TMIN_SECONDARY,
                                           device=dev),
                                torch.full((2 * S,), math.inf, device=dev))
        le = torch.zeros((2 * S, 3), device=dev)
        lpos = torch.zeros((2 * S, 3), device=dev)
        lnrm = torch.zeros((2 * S, 3), device=dev)
        on = torch.nonzero(tri >= 0)[:, 0]
        h2 = plain.surface(fl, tri[on], o2[on], w2[on])
        le[on] = plain._emission(fl, h2.mesh, _dot(-w2[on], h2.fn) > 0)
        lpos[on], lnrm[on] = h2.pos, h2.fn
        hj = _sub(hd, j)
        mat = plain.materials(fl, hd.mesh[j])
        wid = wi.detach()[j]
        zero = torch.zeros(S, device=dev)
        fp = plain.bsdf(mat, hj, wid, wp, zero)
        fm = plain.bsdf(mat, hj, wid, wm, zero)
        jump = fm * le[S:] - fp * le[:S]
        weight = (adj_flat[pixel[j]] * jump).sum(-1) * speed * inv_pdf
        # The lit side's light point, and the strategies' shares there.
        lit_m = plain._lum(le[S:]) > 0
        lp = torch.where(lit_m[:, None], lpos[S:], lpos[:S])
        ln = torch.where(lit_m[:, None], lnrm[S:], lnrm[:S])
        to_l = lp - p
        d2 = _dot(to_l, to_l).clamp_min(1e-20)
        geo = _dot(w, ln).abs() / d2
        p_light = lights.pmf[light.k] / lights.area[light.k]
        pdf = plain.bsdf_pdf(mat, hj, wid, w, zero)
        w_nee = plain._mis(p_light.expand(S), pdf * geo)
        w_bsdf = 1.0 - w_nee
        pd, _ = plain._lobe_pmfs(mat)
        diff = pd * _dot(hj.fn, w).abs() / math.pi
        r_d = torch.where(pdf > 0, diff / pdf.clamp_min(1e-30), 0.0)
        r_s = torch.where(pdf > 0, 1.0 - r_d, 0.0)
        fx, fy, fnn = hj.fx, hj.fy, hj.fn
        loc_d = torch.stack([_dot(w, fx), _dot(w, fy), _dot(w, fnn)], -1)
        m0 = _unit(wid + w)
        loc_s = torch.stack([_dot(m0, fx), _dot(m0, fy), _dot(m0, fnn)], -1)
    # The differentiable ends: the edge point, the shading point, its
    # frame and the incoming direction.
    x_t = v[topo.v0[e]] + tau[:, None] * (v[topo.v1[e]] - v[topo.v0[e]])
    p_t = h.pos[j]
    fx_t, fy_t, fn_t = h.fx[j], h.fy[j], h.fn[j]
    wi_t = wi[j]

    def world(loc):
        return (fx_t * loc[:, 0:1] + fy_t * loc[:, 1:2]
                + fn_t * loc[:, 2:3])

    w_d = world(loc_d)
    m_t = world(loc_s)
    w_s = 2.0 * _dot(wi_t, m_t)[:, None] * m_t - wi_t
    moved = (_dot(nrm, _unit(x_t - p_t))
             - w_nee * _dot(nrm, _unit(lp - p_t))
             - w_bsdf * (r_d * _dot(nrm, w_d) + r_s * _dot(nrm, w_s)))
    return (weight * moved).sum()


@contextlib.contextmanager
def _float32():
    """Both TF32 switches off (the edge search's products are float32)."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def surrogate(scene, adj, spp, seed, max_bounces, primary_on, secondary_on,
              topo=None):
    """The edge surrogate of the samplers that are on, for an image whose
    adjoint is adj (H, W, 3)."""
    dev = scene.camera.position.device
    out = torch.zeros((), device=dev)
    if not (primary_on or secondary_on):
        return out
    topo = topology(scene) if topo is None else topo
    fl = plain.flatten(scene)
    lights = plain.light_tables(scene)
    with _float32():
        if primary_on:
            out = out + primary(scene, fl, lights, topo, adj, spp, seed,
                                max_bounces)
        if secondary_on:
            out = out + secondary(scene, fl, lights, topo, adj, spp, seed,
                                  max_bounces)
    return out
