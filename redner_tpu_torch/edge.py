"""Edge sampling: unbiased gradients of visibility discontinuities (port of
redner_tpu/edge.py; reference src/edge.cpp, Li et al. 2018).

The hand-derived edge adjoints of the reference become *surrogate
scalars* whose torch autograd gradient is the edge estimator:

    grad += d/dtheta  sum_s  w_s . <n_hat_s, x_s(theta)>

with the weight w_s (radiance jump x pixel adjoint / pdf) and the
discontinuity normal n_hat detached, and x_s the differentiable screen
(primary) or sphere (secondary) position of the edge point.  Every other
quantity, the offset-ray pair traces included, is computed without a
graph (`torch.no_grad`), where the JAX package stop-gradients it.

Ties and picks follow the JAX package exactly: every sort is stable, and
`sum(cdf <= x)` / `sum(cdf < x)` are computed as searches that count the
same elements.  The estimator constants are module globals read at each
call; the port runs eagerly, so a changed constant takes effect on the
next call.

Primary edges run under every camera: linear cameras sample the clipped
chord, fisheye, panorama and distorted cameras the film arc (a
forward-mode derivative of the projection along the edge, see
_sample_primary_edges).  Not ported: the JAX package's tail-analysis
debug hook.

Under a pixel sharding (parallel.sharding) every rank draws all primary
edge samples, builds the pmf and the Morton order, and evaluates its block
of the sorted samples, keyed by their global positions; the secondary
edges run on the rank's lanes, and the firefly clamp's population sums
are summed over the ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from redner_tpu_torch import sampler as sampler_mod
from redner_tpu_torch.camera import (CameraType, project, sample_primary,
                                     world_to_cam)
from redner_tpu_torch.core import transform as xf
from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.core.shardutil import (all_reduce_sum, lane_block,
                                             shard_count, shard_rank)
from redner_tpu_torch.core.types import Ray, RayDifferential
from redner_tpu_torch.ops.intersect_cuda import _morton3

# Dihedral-angle threshold: near-coplanar interior edges never become
# silhouettes (src/edge.h:187-196).
COPLANAR_EPS = 1e-6
# Screen-space offset of the primary-edge ray pair (1e-5 of the screen:
# resolvable in f32, far below a pixel).
PRIMARY_EDGE_OFFSET = 1e-5
# Half-plane offset scale of the secondary-edge ray pair (src/edge.cpp:1674).
SECONDARY_EDGE_OFFSET = 1e-5
# Importance-resampling candidates per shading point.
RESAMPLE_M = 32
# Lane x cluster elements per run of the secondary-edge candidate draw.
CANDIDATE_CHUNK = 1 << 23
# Lanes per chunk of the primary-edge offset-ray evaluation.
EDGE_EVAL_CHUNK = 1 << 15
# 2-level secondary-edge sampler: slots per cluster and the cluster cap.
EDGE_SLOT_TARGET = 368
EDGE_CLUSTERS_MAX = 512
# NEE-importance kernel width and floor of the secondary RIS target.
NEE_SIGMA = 0.15
NEE_FLOOR = 0.01
T_CANDIDATES = 8
# Share of the cluster draw given to the generic (horizon-weighted
# 1/dist^2) component of the proposal mixture.
GENERIC_MIX_LAMBDA = 0.2
# Scale proposal mass and RIS target of light-rim edges by their emission
# luminance (off: measured worse in the JAX package).
EMISSION_BOOST = False
# Systematic (across-lane stratified) RIS selection (off: A/B only).
STRAT_SEL = False
# Firefly clamp multiple on the winsorized mean of z = |w|/dist; 0 = off.
SECONDARY_CLAMP_K = 50.0
# Fold |d omega/dt| into the t-candidate RIS target.
T_SPEED_TARGET = True

_U32 = 0xFFFFFFFF


@dataclass
class EdgeSoA:
    """Edge table with static shape (3F,) + validity mask."""

    v0: torch.Tensor  # (E,) int64 welded vertex id (min)
    v1: torch.Tensor  # (E,) int64 welded vertex id (max)
    f0: torch.Tensor  # (E,) int64 face id
    f1: torch.Tensor  # (E,) int64 face id or -1 (boundary)
    valid: torch.Tensor  # (E,) bool, first occurrence of a geometric edge


def _stable_lexsort(keys):
    """torch version of jnp.lexsort: the LAST key is the primary one; ties
    keep their input order."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _count_le(values, q):
    """sum(values <= q[..., None], -1) for a 1-D `values` in any order
    (the JAX package's searchsorted_right), without the (N, E) compare."""
    return torch.searchsorted(torch.sort(values).values, q.contiguous(),
                              right=True)


def _count_lt(cdf, x):
    """sum(cdf[p] < x[p, k]) for rows of a non-decreasing cdf (P, C) and
    thresholds x (P, K): the JAX package's sum-of-compare pick, as a left
    search."""
    return torch.searchsorted(cdf, x.contiguous())


def _weld_vertex_ids(fs) -> torch.Tensor:
    """(V,) canonical vertex id per vertex: vertices of the same shape at
    bit-identical positions share one id (the smallest original id), so
    per-face vertex splits do not turn every edge into a boundary.  A
    load-time eps weld (fs.weld_ids) composes in: each vertex is keyed on
    its weld representative's position."""
    v = fs.vertices.detach()
    if fs.weld_ids is not None:
        v = v[fs.weld_ids]
    V = v.shape[0]
    vshape = torch.zeros((V,), dtype=torch.int64, device=v.device)
    vshape[fs.faces.reshape(-1)] = fs.face_shape_id.repeat_interleave(3)
    order = _stable_lexsort((v[:, 2], v[:, 1], v[:, 0], vshape))
    vs = v[order]
    ss = vshape[order]
    same = torch.cat([
        torch.zeros((1,), dtype=torch.bool, device=v.device),
        (ss[1:] == ss[:-1]) & torch.all(vs[1:] == vs[:-1], dim=-1),
    ])
    # Forward-fill each group's first sorted position; the sort is stable,
    # so a group's first element holds its smallest original id.
    pos = torch.arange(V, device=v.device)
    first_pos = torch.cummax(torch.where(~same, pos, torch.zeros_like(pos)),
                             dim=0).values
    canon = torch.empty_like(order)
    canon[order] = order[first_pos]
    return canon


def build_edges(fs) -> EdgeSoA:
    """Unique mesh edges with adjacency: the 3 edges of every face keyed by
    the sorted welded vertex pair, a stable sort bringing duplicates
    together and a first-occurrence mask (src/edge.cpp:250-296)."""
    faces = fs.faces
    F = faces.shape[0]
    canon = _weld_vertex_ids(fs)
    a = canon[torch.cat([faces[:, 0], faces[:, 1], faces[:, 2]])]
    b = canon[torch.cat([faces[:, 1], faces[:, 2], faces[:, 0]])]
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    face_id = torch.arange(F, device=faces.device).repeat(3)
    nondegen = lo != hi
    order = torch.argsort(lo * fs.vertices.shape[0] + hi, stable=True)
    lo_s, hi_s, f_s = lo[order], hi[order], face_id[order]
    false = torch.zeros((1,), dtype=torch.bool, device=faces.device)
    same_prev = torch.cat([
        false, (lo_s[1:] == lo_s[:-1]) & (hi_s[1:] == hi_s[:-1])])
    same_next = torch.cat([same_prev[1:], false])
    f1 = torch.where(same_next, torch.roll(f_s, -1), torch.full_like(f_s, -1))
    return EdgeSoA(v0=lo_s, v1=hi_s, f0=f_s, f1=f1,
                   valid=~same_prev & nondegen[order])


def _num_clusters(E: int) -> int:
    return max(1, min(EDGE_CLUSTERS_MAX, E,
                      max(32, -(-E // EDGE_SLOT_TARGET))))


@dataclass
class EdgeTable:
    """Per-backward edge data of the secondary-edge pass (all detached).

    packed: (E, 16) rows [a(3) b(3) n0(3) n1(3) flag pad3], flag 0 = never
    a silhouette, 1 = interior candidate, 2 = boundary.  slot_edge maps
    (cluster, slot) -> edge id (-1 pad); slot_packed holds the slot-ordered
    rows [a b n0 n1 flag eid boost pad]; the cluster centers, radii and
    weights drive the level-1 importance."""

    edges: EdgeSoA
    packed: torch.Tensor  # (E, 16)
    slot_edge: torch.Tensor  # (C, S) int64
    slot_packed: torch.Tensor  # (C, S, 16)
    cluster_center: torch.Tensor  # (C, 3)
    cluster_radius: torch.Tensor  # (C,)
    cluster_weight: torch.Tensor  # (C,)


def _face_normals(fs, face_id):
    """Geometric unit normals of (clamped) face ids."""
    fid = torch.clamp(face_id, 0, fs.num_triangles - 1)
    f = fs.faces[fid]
    v0 = fs.vertices[f[..., 0]]
    v1 = fs.vertices[f[..., 1]]
    v2 = fs.vertices[f[..., 2]]
    return vm.normalize(vm.cross(v1 - v0, v2 - v0))


@torch.no_grad()
def build_edge_table(fs) -> EdgeTable:
    edges = build_edges(fs)
    a = fs.vertices[edges.v0]
    b = fs.vertices[edges.v1]
    n0 = _face_normals(fs, edges.f0)
    n1 = _face_normals(fs, edges.f1)
    dtype, dev = a.dtype, a.device
    boundary = edges.f1 < 0
    coplanar = vm.dot(n0, n1) >= 1.0 - COPLANAR_EPS
    one = torch.ones_like(a[:, 0])
    flag = torch.where(edges.valid & (boundary | ~coplanar),
                       torch.where(boundary, 2.0 * one, one), 0.0 * one)
    E = a.shape[0]
    packed = torch.cat(
        [a, b, n0, n1, flag[:, None], torch.zeros((E, 3), dtype=dtype,
                                                   device=dev)], dim=-1)

    mid = 0.5 * (a + b)
    length = vm.length(b - a)
    # Silhouette prior: 1 for boundary edges, exterior dihedral / pi for
    # interior ones (src/edge_tree.cpp:25-75).
    dih = torch.arccos(vm.clip(vm.dot(n0, n1), -1.0, 1.0))
    prior = torch.where(flag == 2.0, one,
                        torch.where(flag == 1.0, dih / math.pi, 0.0 * one))
    if fs.num_area_lights > 0 and EMISSION_BOOST:
        F = fs.num_triangles
        lid0 = fs.face_light_id[torch.clamp(edges.f0, 0, F - 1)]
        lid1 = torch.where(edges.f1 >= 0,
                           fs.face_light_id[torch.clamp(edges.f1, 0, F - 1)],
                           torch.full_like(edges.f1, -1))
        lid = torch.maximum(
            torch.where(edges.f0 >= 0, lid0, torch.full_like(lid0, -1)), lid1)
        lum = vm.luminance(
            fs.light_intensity[torch.clamp(lid, 0, fs.num_area_lights - 1)])
        boost = torch.where(lid >= 0, 1.0 + lum, one)
    else:
        boost = one
    w_e = length * prior * boost

    lo = torch.min(mid, dim=0).values
    hi = torch.max(mid, dim=0).values
    qz = vm.clip((mid - lo) / vm.maximum(hi - lo, 1e-12) * 1024.0, 0.0, 1023.0)
    codes = _morton3(qz.to(torch.int64))
    # Dead edges (w_e == 0) sort to the tail (bit 31).
    key = codes | torch.where(w_e > 0, 0, 1 << 31)
    order = torch.argsort(key, stable=True)

    C = _num_clusters(E)
    S = -(-E // C)
    pad = C * S - E
    order_p = torch.cat(
        [order, torch.full((pad,), -1, dtype=order.dtype, device=dev)]
    ).reshape(C, S)
    slot_valid = order_p >= 0
    order_c = torch.clamp(order_p, 0, E - 1)
    w_slot = torch.where(slot_valid, w_e[order_c], 0.0)
    mid_slot = mid[order_c]
    w_c = torch.sum(w_slot, dim=-1)
    live = w_slot > 0
    n_live = torch.clamp_min(torch.sum(live, dim=-1), 1)
    center = torch.sum(torch.where(live[..., None], mid_slot, 0.0),
                       dim=1) / n_live[:, None].to(dtype)
    radius = torch.sqrt(torch.max(
        torch.where(live, torch.sum((mid_slot - center[:, None, :]) ** 2,
                                    dim=-1), 0.0),
        dim=-1).values)
    eid_col = torch.where(slot_valid, order_c, -1).to(dtype)
    boost_col = torch.where(slot_valid, boost[order_c], 1.0)
    slot_packed = torch.cat([
        torch.where(slot_valid[..., None], packed[order_c][..., :13], 0.0),
        eid_col[..., None],
        boost_col[..., None],
        torch.zeros((C, S, 1), dtype=dtype, device=dev),
    ], dim=-1)
    return EdgeTable(edges=edges, packed=packed, slot_edge=order_p,
                     slot_packed=slot_packed, cluster_center=center,
                     cluster_radius=radius, cluster_weight=w_c)


def silhouette_mask(fs, edges: EdgeSoA, viewpoint):
    """Which edges are silhouettes w.r.t. `viewpoint` (..., 3): boundary
    edges always, interior edges iff exactly one adjacent face fronts the
    viewpoint, near-coplanar edges never (src/edge.h:156-229)."""
    n0 = _face_normals(fs, edges.f0)
    n1 = _face_normals(fs, edges.f1)
    p0 = fs.vertices[edges.v0]
    boundary = edges.f1 < 0
    coplanar = vm.dot(n0, n1) >= 1.0 - COPLANAR_EPS
    d = viewpoint - p0
    front0 = vm.dot(n0, d) > 0
    front1 = vm.dot(n1, d) > 0
    return edges.valid & (boundary | ((front0 != front1) & ~coplanar))


# ----------------------------------------------------------------------
# Primary edges (screen-space discontinuities)
# ----------------------------------------------------------------------


def _clip_segment_screen(p0, p1, valid0, valid1, width, height):
    """Liang-Barsky clip of screen segments (pixel units) to the image box
    (src/line_clip.h).  Returns (t0, t1, ok)."""
    d = p1 - p0
    tmin = torch.zeros(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    tmax = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    ok = valid0 & valid1
    for axis, lim in ((0, width), (1, height)):
        dd = d[..., axis]
        pp = p0[..., axis]
        flat = dd == 0
        safe_dd = torch.where(flat, torch.ones_like(dd), dd)
        t_lo = (0.0 - pp) / safe_dd
        t_hi = (lim - pp) / safe_dd
        tmin = torch.where(flat, tmin, torch.maximum(tmin, torch.minimum(t_lo, t_hi)))
        tmax = torch.where(flat, tmax, torch.minimum(tmax, torch.maximum(t_lo, t_hi)))
        ok = ok & (~flat | ((pp >= 0.0) & (pp <= lim)))
    return tmin, tmax, ok & (tmax > tmin)


def project_pixels(camera, p_world):
    """World -> screen in pixel units (x right, y down), differentiable."""
    screen, valid, _ = project(camera, p_world)
    scale = const((float(camera.width), float(camera.height)), screen.dtype,
                  screen.device)
    return screen * scale, valid


def _sample_primary_edges(scene, flatten_scene_fn, render_sample_fn, options,
                          seed, num_edge_samples: int, engine=None,
                          lane_sharding=None):
    """Silhouette extraction, clipping, pmf, sampling and the two-sided
    offset-ray evaluation of the primary-edge estimator.  Returns a dict:
    x_pix (N, 2) differentiable screen point of each sample, n_hat its
    screen normal, f_plus/f_minus (N, C) the two sides' evaluations, pdf
    per unit pixel length, px/py the containing pixel, inside, any_edges,
    N.

    Linear cameras (perspective, orthographic) sample the viewport-clipped
    chord of each edge.  Under fisheye, panorama and distorted cameras an
    edge images to an arc: the whole near-clipped segment is sampled with
    its chord length + 1 as importance, the sample is the projection of
    the 3D edge point, and its screen tangent and |dx/ds| come from a
    forward-mode derivative of the projection along the edge parameter
    (the film-arc branch, src/edge.cpp:482-592).

    lane_sharding: the per-sample arrays hold this rank's block of the N
    Morton-sorted samples (core.shardutil.lane_block); N stays the global
    count."""
    camera = scene.camera
    fs = flatten_scene_fn(scene)
    dtype, dev = fs.vertices.dtype, fs.device
    top, left, bottom, right = camera.viewport_or_full
    width, height = float(camera.width), float(camera.height)
    N = num_edge_samples
    edge_seed = (seed + sampler_mod.EDGE_SEED_OFFSET) & _U32
    # A 3D line images to a curve (the film arc) under these cameras.
    nonlinear = (camera.camera_type in (CameraType.fisheye,
                                        CameraType.panorama)
                 or camera.has_distortion)

    with torch.no_grad():
        edges = build_edges(fs)
        center_ray = sample_primary(camera, torch.full(
            (1, 2), 0.5, dtype=dtype, device=dev))
        if camera.camera_type == CameraType.orthographic:
            # The viewpoint is at infinity along -view: a point far behind
            # the film plane classifies silhouettes the same way for any
            # scene of finite extent.
            span = 2.0 * fs.bsphere_radius + 1.0
            cam_org = fs.bsphere_center - center_ray.dir[0] * (span * 1e3)
        else:
            cam_org = center_ray.org[0]
        sil = silhouette_mask(fs, edges, cam_org)
        ev0 = fs.vertices[edges.v0]
        ev1 = fs.vertices[edges.v1]
        front_ok = None
        tz0 = torch.zeros(ev0.shape[:-1], dtype=dtype, device=dev)
        tz1 = torch.ones_like(tz0)
        if camera.camera_type in (CameraType.perspective,
                                  CameraType.orthographic):
            # Near-plane clip (src/camera.h:563-590): the clip parameter
            # moves endpoints along the edge, so it carries no gradient.
            w2c = world_to_cam(camera)
            z0 = xf.xfm_point(w2c, ev0)[..., 2]
            z1 = xf.xfm_point(w2c, ev1)[..., 2]
            near = camera.clip_near
            behind0 = z0 <= near
            behind1 = z1 <= near
            front_ok = ~(behind0 & behind1)
            dz = z1 - z0
            s = torch.where(
                torch.abs(dz) > 1e-20,
                (near - z0) / torch.where(dz == 0, torch.ones_like(dz), dz),
                torch.zeros_like(dz))
            tz0 = torch.where(behind0, s, tz0)
            tz1 = torch.where(behind1, s, tz1)
        p0_pix, _ = project_pixels(camera, ev0 + tz0[..., None] * (ev1 - ev0))
        p1_pix, _ = project_pixels(camera, ev0 + tz1[..., None] * (ev1 - ev0))
        if nonlinear:
            # Clipping to the chord's viewport intersection would zero the
            # pmf of edges whose arc crosses the screen while the chord
            # misses it (a bias); the per-sample `inside` mask and the
            # arc's true Jacobian in the pdf keep the whole segment
            # unbiased.  The + 1 floors arcs whose endpoints project
            # together (panorama wrap).
            t0 = torch.zeros_like(tz0)
            t1 = torch.ones_like(tz0)
            use = sil if front_ok is None else sil & front_ok
            seg_len = vm.length(p1_pix - p0_pix) + 1.0
        else:
            t0, t1, clip_ok = _clip_segment_screen(p0_pix, p1_pix, front_ok,
                                                   front_ok, width, height)
            use = sil & clip_ok
            seg_len = vm.length(p1_pix - p0_pix) * (t1 - t0)
        weight_len = torch.where(use, seg_len, 0.0)
        total = torch.sum(weight_len)
        any_edges = total > 0
        pmf = weight_len / vm.maximum(total, 1e-20)
        cdf = vm.cumsum(pmf, dim=0) - pmf

        u = sampler_mod.draw(options.sampler_type, edge_seed, 0,
                             torch.arange(N, device=dev), 0, 2)
        sel = torch.clamp(_count_le(cdf, u[:, 0]) - 1, 0, cdf.shape[0] - 1)
        tt = t0[sel] + (t1[sel] - t0[sel]) * u[:, 1]

        # Order the samples by a screen-position Morton key (the chord-lerp
        # preview), so every ray tile covers a compact screen region and the
        # ray queries can skip their own sort (rays_coherent=True below).
        wh = const((width, height), dtype, dev)
        prev = torch.minimum(vm.maximum(torch.nan_to_num(
            (1.0 - tt)[:, None] * p0_pix[sel] + tt[:, None] * p1_pix[sel]),
            0.0), wh)
        p_lo = torch.min(prev, dim=0).values
        p_hi = torch.max(prev, dim=0).values
        q = vm.clip((prev - p_lo) / vm.maximum(p_hi - p_lo, 1e-6) * 1023.0,
                    0.0, 1023.0).to(torch.int64)
        perm = torch.argsort(_morton3(torch.cat(
            [q, torch.zeros((N, 1), dtype=torch.int64, device=dev)], -1)),
            stable=True)
        # This rank's block of the sorted samples (all of them unsharded).
        lo, hi = lane_block(N, shard_rank(lane_sharding),
                            shard_count(lane_sharding))
        sel = sel[perm[lo:hi]]
        tt = tt[perm[lo:hi]]
        tz0s, tz1s = tz0[sel], tz1[sel]

    # Differentiable screen point of the sample on the near-plane-clipped
    # endpoints.
    ev0s = fs.vertices[edges.v0[sel]]
    ev1s = fs.vertices[edges.v1[sel]]
    a3 = ev0s + tz0s[..., None] * (ev1s - ev0s)
    b3 = ev0s + tz1s[..., None] * (ev1s - ev0s)
    if nonlinear:
        # The film arc: project the 3D edge point itself; the screen
        # tangent and |dx/ds| are the forward-mode derivative of the
        # projection along the edge parameter, on detached endpoints.
        x_pix, _ = project_pixels(camera, a3 + tt[:, None] * (b3 - a3))
        a3d, b3d = a3.detach(), b3.detach()

        def pix_of(s):
            return project_pixels(camera, a3d + s[:, None] * (b3d - a3d))[0]

        with torch.no_grad():
            _, dxds = torch.func.jvp(pix_of, (tt,), (torch.ones_like(tt),))
            arc_speed = vm.length(dxds)
            e_dir = dxds / vm.maximum(arc_speed, 1e-20)[:, None]
    else:
        # Linear cameras: the film image of the edge is its chord.
        a_pix, _ = project_pixels(camera, a3)
        b_pix, _ = project_pixels(camera, b3)
        x_pix = (1.0 - tt)[:, None] * a_pix + tt[:, None] * b_pix
        with torch.no_grad():
            arc_speed = vm.length(b_pix - a_pix)
            e_dir = vm.normalize(b_pix - a_pix)

    with torch.no_grad():
        n_hat = torch.stack([-e_dir[..., 1], e_dir[..., 0]], dim=-1)
        xs = x_pix.detach()
        screen_plus = (xs + PRIMARY_EDGE_OFFSET * wh * n_hat) / wh
        screen_minus = (xs - PRIMARY_EDGE_OFFSET * wh * n_hat) / wh
        ray_p = sample_primary(camera, screen_plus)
        ray_m = sample_primary(camera, screen_minus)
        both_org = torch.cat([ray_p.org, ray_m.org])
        both_dir = torch.cat([ray_p.dir, ray_m.dir])
        # Both sides of a pair share the sample's global sorted position as
        # RNG key (common random numbers), so f_plus - f_minus isolates the
        # visibility jump.
        nb = hi - lo
        lanes = torch.arange(lo, hi, device=dev).repeat(2)
        two_n = 2 * nb
        # max(1, .): a rank past the last sample has an empty block and
        # evaluates no chunk.
        chunk = max(1, min(two_n, EDGE_EVAL_CHUNK))
        nch = -(-two_n // chunk)
        pad = nch * chunk - two_n
        if pad:
            z3 = torch.zeros((pad, 3), dtype=dtype, device=dev)
            both_org = torch.cat([both_org, z3])
            both_dir = torch.cat([both_dir, z3])
            lanes = torch.cat([lanes, torch.zeros((pad,), dtype=lanes.dtype,
                                                  device=dev)])
        f_both = torch.cat([
            render_sample_fn(
                fs, camera, options, edge_seed, 0,
                primary_rays=(
                    Ray.make(both_org[c * chunk:(c + 1) * chunk],
                             both_dir[c * chunk:(c + 1) * chunk]),
                    RayDifferential.zero((chunk,), dtype, dev)),
                pixel_order=lanes[c * chunk:(c + 1) * chunk],
                precise_primary=True, rays_coherent=True, engine=engine)
            for c in range(nch)
        ] or [both_org.new_zeros(
            (0, options.channel_info.num_total_dimensions))])[:two_n]

        px = torch.clamp(xs[:, 0].to(torch.int64) - left, 0, right - left - 1)
        py = torch.clamp(xs[:, 1].to(torch.int64) - top, 0, bottom - top - 1)
        inside = ((xs[:, 0] >= left) & (xs[:, 0] < right)
                  & (xs[:, 1] >= top) & (xs[:, 1] < bottom))
        # Density per unit pixel length: edge pmf x uniform-in-t density
        # over the screen length of the clipped chord.
        pdf = pmf[sel] / vm.maximum(arc_speed * (t1 - t0)[sel], 1e-20)
    return {"x_pix": x_pix, "xs": xs, "n_hat": n_hat,
            "f_plus": f_both[:nb], "f_minus": f_both[nb:], "pdf": pdf,
            "px": px, "py": py, "inside": inside, "any_edges": any_edges,
            "N": N}


def primary_edge_gradients(scene, flatten_scene_fn, render_sample_fn, options,
                           seed, d_image, num_edge_samples: int, engine=None,
                           lane_sharding=None):
    """Surrogate scalar whose gradient is the primary (screen-space)
    silhouette contribution (src/edge.cpp:385-652, Eq. 8):

        dI_p/dtheta += (f_minus - f_plus) . d_image[p] / pdf
                       * <n_hat, dx/dtheta>

    d_image: (vh, vw, C) adjoint of the full channel image.  The gradient
    flows through x_pix to the vertices and the camera.  lane_sharding:
    the surrogate of this rank's block of samples."""
    s = _sample_primary_edges(scene, flatten_scene_fn, render_sample_fn,
                              options, seed, num_edge_samples, engine,
                              lane_sharding)
    with torch.no_grad():
        d_pix = d_image.detach()[s["py"], s["px"]]
        w = torch.sum((s["f_minus"] - s["f_plus"]) * d_pix, dim=-1)
        w = w / vm.maximum(s["pdf"], 1e-20)
        w = torch.where(s["inside"] & (s["pdf"] > 0) & s["any_edges"], w,
                        torch.zeros_like(w)) / s["N"]
    return torch.sum(w * torch.sum(s["n_hat"] * s["x_pix"], dim=-1))


def primary_edge_screen_gradient_image(scene, flatten_scene_fn,
                                       render_sample_fn, options, seed,
                                       num_edge_samples: int, image_shape,
                                       engine=None):
    """Dirac (edge) part of the screen-gradient image -> (vh, vw, 2, C)
    (src/edge.cpp:765-773): crossing a silhouette along +n_hat the channel
    value jumps from f_minus to f_plus, so each edge sample scatters
    (f_plus - f_minus) n_hat / pdf into the pixel that contains it.  The
    continuous part is screen_gradient's forward-mode derivative."""
    s = _sample_primary_edges(scene, flatten_scene_fn, render_sample_fn,
                              options, seed, num_edge_samples, engine)
    vh, vw, _, C = image_shape
    with torch.no_grad():
        valid = s["inside"] & (s["pdf"] > 0) & s["any_edges"]
        w = (s["f_plus"] - s["f_minus"]) / vm.maximum(s["pdf"], 1e-20)[:, None]
        w = torch.where(valid[:, None], w, torch.zeros_like(w)) / s["N"]
        contrib = s["n_hat"][:, :, None] * w[:, None, :]  # (N, 2, C)
        img = torch.zeros((vh * vw, 2, C), dtype=w.dtype, device=w.device)
        img.index_add_(0, s["py"] * vw + s["px"], contrib)
    return img.reshape(vh, vw, 2, C)


# ----------------------------------------------------------------------
# Secondary edges (shadow / global-illumination discontinuities)
# ----------------------------------------------------------------------


def firefly_scale(z, clamp_k, wins_cap: float = 20.0, lane_sharding=None):
    """Per-lane down-scaling factors min(1, tau/z) for the firefly clamp:
    tau = clamp_k x a two-pass winsorized mean of z over the lanes with
    z > 0 (the lanes whose offset pair straddles).  lane_sharding: z holds
    this rank's lanes, and the sums run over every rank's
    (shardutil.all_reduce_sum, whose backward sums the ranks'
    cotangents), so tau's derivative in z is the one-process one on every
    rank.  In secondary_edge_surrogate z is made under no_grad from
    quantities the JAX package stops gradients of (w and dist,
    redner_tpu/edge.py:1262, :1360-1361), so there no derivative of tau
    reaches a leaf."""
    count_sum = all_reduce_sum(
        torch.stack([torch.sum((z > 0).to(z.dtype)), torch.sum(z)]),
        lane_sharding)
    n_nz = vm.maximum(count_sum[0], 1.0)
    m1 = count_sum[1] / n_nz
    robust_mean = all_reduce_sum(
        torch.sum(torch.minimum(z, wins_cap * m1)), lane_sharding) / n_nz
    tau = clamp_k * vm.maximum(robust_mean, 1e-12)
    return vm.minimum(tau / vm.maximum(z, 1e-30), 1.0)


def secondary_edge_surrogate(
    fs,
    options,
    seed,
    sample_id,
    sp_position,
    sp_wi,
    bsdf_eval_fn,
    trace_fn,
    d_pixel,
    active,
    nee_dir=None,
    dim_base: int = 100,
    bsdf_pdf_fn=None,
    specular_dir=None,
    specular_sigma=None,
    specular_weight=None,
    lane_ids=None,
    edge_table: EdgeTable = None,
    shading_normal=None,
    engine=None,
    lane_sharding=None,
):
    """Surrogate scalar for secondary-edge gradients at P shading points
    (src/edge.cpp:1115-2073, Eqs. 13-18).

    For each shading point: pick a cluster of edges from a per-point
    importance (level 1) and a slot inside it (level 2) for each of
    RESAMPLE_M candidates, resample one silhouette candidate in proportion
    to its target over its proposal density, pick a point on it from
    T_CANDIDATES stratified t candidates, trace the +-offset ray pair and
    emit  w . <n_hat, omega(a, b, p)>,  whose gradient is the sphere-space
    edge integral; the chain through p = sp_position reaches the upstream
    path.  At the light's own rim the gradient toward p weights the
    emission part of the jump by the BSDF-strategy MIS weight.

    sp_position (P, 3) differentiable; sp_wi (P, 3); bsdf_eval_fn(wo) ->
    (P, 3); d_pixel (P, 3) throughput-weighted adjoint; active (P,);
    nee_dir/specular_dir (P, 3), specular_sigma/weight (P,) steer the RIS
    kernel; lane_ids (P,) RNG keys (default arange(P)); sample_id scalar or
    (P,); trace_fn is render.trace_radiance; engine goes to its ray
    queries; lane_sharding: the P lanes are this rank's, and the firefly
    clamp's population runs over every rank's lanes."""
    P = sp_position.shape[0]
    dtype, dev = sp_position.dtype, sp_position.device
    edge_seed = seed + sampler_mod.EDGE_SEED_OFFSET
    lane = (torch.arange(P, device=dev) if lane_ids is None
            else torch.as_tensor(lane_ids, dtype=torch.int64, device=dev))
    per_lane_sid = torch.is_tensor(sample_id) and sample_id.dim() == 1
    if edge_table is None:
        edge_table = build_edge_table(fs)
    edges = edge_table.edges
    E = edges.v0.shape[0]
    has_kernel = nee_dir is not None or specular_dir is not None
    M = RESAMPLE_M

    with torch.no_grad():
        p_sg = sp_position.detach()
        u_qmc = sampler_mod.draw(options.sampler_type, edge_seed, lane,
                                 sample_id, dim_base + 5, 3)
        if STRAT_SEL:
            # Strata are positions among this call's lanes: under a pixel
            # sharding they would need the global lane positions.
            u_sel_all = torch.fmod(
                torch.arange(P, dtype=dtype, device=dev) / P + u_qmc[0, 0],
                1.0)
        else:
            u_sel_all = u_qmc[:, 0]

        def pick_edges(lane, sample_id, p_sg, nee_dir, specular_dir,
                       specular_sigma, specular_weight, shading_normal,
                       u_sel):
            """The two-level draw and the RIS pick for a run of lanes ->
            (picked edge id, RIS factor, has a candidate)."""
            sid_col = sample_id[:, None] if per_lane_sid else sample_id
            # --- M candidates per shading point from the two-level draw ---
            m_ids = torch.arange(M, device=dev)
            mkey = lane[:, None] * M + m_ids[None, :]
            # Stratified cluster draws mod(u0 + i/M, 1)
            # (src/edge.cpp:1483-1494); slot draws independent per (lane,
            # candidate).
            u0 = sampler_mod.uniform(edge_seed, lane, sample_id, dim_base + 4)
            u_c = torch.fmod(u0[:, None] + m_ids[None, :].to(dtype) / M, 1.0)
            u_s = sampler_mod.uniform(edge_seed, mkey, sid_col, dim_base + 8)

            centers = edge_table.cluster_center
            radii = edge_table.cluster_radius
            wclu = edge_table.cluster_weight
            S = edge_table.slot_edge.shape[1]
            cvec = centers[None, :, :] - p_sg[:, None, :]  # (P, C, 3)
            cdist2 = torch.sum(cvec * cvec, dim=-1)
            cdist = torch.sqrt(vm.maximum(cdist2, 1e-12))
            cdirn = cvec / cdist[..., None]
            broad2 = (radii[None, :] / vm.maximum(cdist, 1e-6)) ** 2
            ck_dir = torch.zeros_like(cdist)
            if nee_dir is not None:
                d2 = 2.0 * (1.0 - vm.dot(cdirn, nee_dir[:, None, :]))
                ck_dir = ck_dir + torch.exp(
                    -d2 / (2.0 * (NEE_SIGMA * NEE_SIGMA + broad2)))
            if specular_dir is not None:
                d2s = 2.0 * (1.0 - vm.dot(cdirn, specular_dir[:, None, :]))
                sig2s = (vm.maximum(specular_sigma, 1e-3) ** 2)[:, None]
                ck_dir = ck_dir + specular_weight[:, None] * torch.exp(
                    -d2s / (2.0 * (sig2s + broad2)))
            horiz = 1.0
            if shading_normal is not None:
                horiz = torch.abs(
                    vm.dot(cdirn, shading_normal[:, None, :])) + 0.1
            geom = wclu[None, :] * horiz / vm.maximum(cdist2,
                                                      radii[None, :] ** 2)
            # Two-component normalized proposal mixture: a directional
            # component peaked at the NEE / mirror directions and a generic
            # one.
            geom_n = vm.safe_div(geom, torch.sum(geom, dim=-1, keepdim=True))
            score = GENERIC_MIX_LAMBDA * geom_n
            if has_kernel:
                imp_dir = geom * ck_dir
                dir_sum = torch.sum(imp_dir, dim=-1, keepdim=True)
                score = torch.where(
                    dir_sum > 0,
                    (1.0 - GENERIC_MIX_LAMBDA) * vm.safe_div(imp_dir, dir_sum)
                    + score,
                    geom_n)
            score_sum = torch.sum(score, dim=-1)
            C = score.shape[-1]
            c_cdf = torch.cumsum(score, dim=-1)
            cm = torch.clamp(_count_lt(c_cdf, u_c * score_sum[:, None]), 0,
                             C - 1)
            cprob = vm.safe_div(torch.gather(score, 1, cm), score_sum[:, None])
            slot = torch.clamp((u_s * S).to(torch.int64), 0, S - 1)
            q_cand = cprob / S  # exact pdf of this candidate draw

            rows = edge_table.slot_packed[cm, slot]  # (P, M, 16)
            a = rows[..., 0:3]
            b = rows[..., 3:6]
            n0 = rows[..., 6:9]
            n1 = rows[..., 9:12]
            flag = rows[..., 12]
            eid = rows[..., 13].to(torch.int64)  # exact: E < 2^24
            boost = rows[..., 14]
            cand_live = eid >= 0
            cand = torch.clamp(eid, 0, E - 1)
            d_view = p_sg[:, None, :] - a
            front0 = vm.dot(n0, d_view) > 0
            front1 = vm.dot(n1, d_view) > 0
            sil = (flag == 2.0) | ((flag == 1.0) & (front0 != front1))

            # Target: subtended arc times direction-proximity kernels.
            wa = vm.normalize(a - p_sg[:, None, :])
            wb = vm.normalize(b - p_sg[:, None, :])
            arc = vm.length(wb - wa)
            mid = vm.normalize(wa + wb)

            def arc_d2(target):
                return torch.minimum(
                    torch.minimum(2.0 * (1.0 - vm.dot(wa, target)),
                                  2.0 * (1.0 - vm.dot(wb, target))),
                    2.0 * (1.0 - vm.dot(mid, target)))

            kernel = 1.0
            if has_kernel:
                kernel = torch.full((p_sg.shape[0], M), NEE_FLOOR,
                                    dtype=dtype, device=dev)
                if nee_dir is not None:
                    kernel = kernel + torch.exp(
                        -arc_d2(nee_dir[:, None, :])
                        / (2.0 * NEE_SIGMA * NEE_SIGMA))
                if specular_dir is not None:
                    sig2 = (vm.maximum(specular_sigma, 1e-3) ** 2)[:, None]
                    kernel = kernel + specular_weight[:, None] * torch.exp(
                        -arc_d2(specular_dir[:, None, :]) / (2.0 * sig2))
            if shading_normal is not None:
                n_sg = shading_normal[:, None, :]
                horizon = torch.maximum(
                    torch.maximum(torch.abs(vm.dot(wa, n_sg)),
                                  torch.abs(vm.dot(wb, n_sg))),
                    torch.abs(vm.dot(mid, n_sg)))
                kernel = kernel * (horizon + 0.05)
            # Skip edges through the shading point itself (src/edge.cpp:1866).
            da = vm.distance_squared(a, p_sg[:, None, :])
            db = vm.distance_squared(b, p_sg[:, None, :])
            w_cand = torch.where(sil & cand_live & (da > 1e-8) & (db > 1e-8),
                                 arc * kernel * boost, 0.0)

            # RIS weights m_i = target / proposal; resample one candidate.
            m_w = torch.where(q_cand > 0, vm.safe_div(w_cand, q_cand), 0.0)
            m_sum = torch.sum(m_w, dim=-1)
            has_cand = m_sum > 0
            cdf = torch.cumsum(m_w, dim=-1)
            pick = torch.clamp(_count_lt(cdf, (u_sel * m_sum)[:, None]), 0,
                               M - 1)
            sel = torch.gather(cand, 1, pick)[:, 0]
            w_pick = torch.gather(w_cand, 1, pick)[:, 0]
            ris_factor = torch.where(
                has_cand & (w_pick > 0),
                m_sum / (M * vm.maximum(w_pick, 1e-20)), 0.0)
            return sel, ris_factor, has_cand

        # Per lane the draw holds (C, 3) and (M, 16) rows: run it over runs
        # of lanes so that its working set stays near CANDIDATE_CHUNK
        # elements whatever the lane count.  Every step is per lane, so
        # the result is the same as in one run.
        C = edge_table.slot_edge.shape[0]
        nrun = max(1, -(-P * max(C, M) // CANDIDATE_CHUNK))
        step = max(1, -(-P // nrun))

        def run_of(x, ix):
            return x if x is None or not torch.is_tensor(x) or x.dim() == 0 \
                else x[ix]

        runs = [pick_edges(*(run_of(x, slice(i, i + step)) for x in (
                    lane, sample_id, p_sg, nee_dir, specular_dir,
                    specular_sigma, specular_weight, shading_normal,
                    u_sel_all)))
                for i in range(0, max(P, 1), step)]
        sel, ris_factor, has_cand = (torch.cat(x) for x in zip(*runs))

        # --- point on the chosen edge: stratified t candidates + RIS ---
        av_sg = fs.vertices[edges.v0[sel]]
        bv_sg = fs.vertices[edges.v1[sel]]
        Kt = T_CANDIDATES
        tk = (torch.arange(Kt, dtype=dtype, device=dev)[None, :]
              + u_qmc[:, 1][:, None]) / Kt
        xk = ((1.0 - tk)[..., None] * av_sg[:, None, :]
              + tk[..., None] * bv_sg[:, None, :])
        wk_vec = xk - p_sg[:, None, :]
        dist_k = vm.maximum(vm.length(wk_vec), 1e-6)
        wk_dir = wk_vec / dist_k[..., None]
        if has_kernel:
            wt = torch.full((P, Kt), NEE_FLOOR, dtype=dtype, device=dev)
            if nee_dir is not None:
                d2k = 2.0 * (1.0 - vm.dot(wk_dir, nee_dir[:, None, :]))
                wt = wt + torch.exp(-d2k / (2.0 * NEE_SIGMA * NEE_SIGMA))
            if specular_dir is not None:
                d2ks = 2.0 * (1.0 - vm.dot(wk_dir, specular_dir[:, None, :]))
                sig2 = (vm.maximum(specular_sigma, 1e-3) ** 2)[:, None]
                wt = wt + specular_weight[:, None] * torch.exp(
                    -d2ks / (2.0 * sig2))
        else:
            wt = torch.ones((P, Kt), dtype=dtype, device=dev)
        if T_SPEED_TARGET:
            # Fold the line-measure speed |d omega/dt| ~ |edge|/dist into
            # the t target, so the RIS factor cancels its near-edge spike.
            dxdt_sg = bv_sg - av_sg
            proj_k = (dxdt_sg[:, None, :]
                      - wk_dir * vm.dot(wk_dir, dxdt_sg[:, None, :])[..., None])
            speed_k = vm.length(proj_k) / dist_k
            wt = wt * (speed_k + 1e-4 * torch.max(speed_k, dim=-1,
                                                  keepdim=True).values
                       + 1e-20)
        wt_sum = torch.sum(wt, dim=-1)
        cdf_t = torch.cumsum(wt, dim=-1)
        pick_t = torch.clamp(_count_lt(cdf_t, (u_qmc[:, 2] * wt_sum)[:, None]),
                             0, Kt - 1)
        t = torch.gather(tk, 1, pick_t)[:, 0]
        wt_pick = torch.gather(wt, 1, pick_t)[:, 0]
        t_factor = wt_sum / (Kt * vm.maximum(wt_pick, 1e-20))

        x_sg = (1.0 - t)[:, None] * av_sg + t[:, None] * bv_sg
        omega_sg = vm.normalize(x_sg - p_sg)
        # Arc tangent and sphere normal of the discontinuity at omega.
        dxdt = bv_sg - av_sg
        dist = vm.maximum(vm.length(x_sg - p_sg), 1e-6)
        domega_dt = (dxdt - omega_sg * vm.vdot(omega_sg, dxdt)) / dist[:, None]
        speed = vm.length(domega_dt)
        ehat = vm.normalize(domega_dt)
        n_hat = vm.normalize(vm.cross(omega_sg, ehat))

        # --- radiance difference across the arc ---
        dir_p = vm.normalize(omega_sg + SECONDARY_EDGE_OFFSET * n_hat)
        dir_m = vm.normalize(omega_sg - SECONDARY_EDGE_OFFSET * n_hat)
        live2 = torch.cat([active & has_cand] * 2)
        dist2 = torch.cat([dist, dist])
        ray2 = Ray(
            org=torch.cat([p_sg, p_sg]),
            dir=torch.where(live2[:, None], torch.cat([dir_p, dir_m]), 0.0),
            tmin=torch.full((2 * P,), 1e-3, dtype=dtype, device=dev)
            * vm.maximum(dist2, 1.0),
            tmax=torch.full((2 * P,), float("inf"), dtype=dtype, device=dev),
        )
        # Common random numbers for the pair: both sides share lane keys.
        # The pair is not tile-coherent, so the ray queries sort it.
        sample2 = torch.cat([sample_id, sample_id]) if per_lane_sid \
            else sample_id
        L_both, E_both = trace_fn(
            fs, options, edge_seed, torch.cat([lane, lane]), sample2, ray2,
            RayDifferential.zero((2 * P,), dtype, dev), dim_base + 10,
            camera_ray=False, return_emission=True, precise_primary=True,
            engine=engine)
        L_plus, L_minus = L_both[:P], L_both[P:]
        E_plus, E_minus = E_both[:P], E_both[P:]
        f_plus = bsdf_eval_fn(dir_p)
        f_minus = bsdf_eval_fn(dir_m)

        # w = <d_pixel, f L_minus - f L_plus> * |d omega/dt| * RIS factors
        jac = speed * ris_factor * t_factor
        diff_full = f_minus * L_minus - f_plus * L_plus
        w_full = torch.sum(d_pixel * diff_full, dim=-1) * jac
        if bsdf_pdf_fn is not None and fs.num_area_lights > 0:
            # The light's own rim: the emission part of the jump gets the
            # BSDF-strategy MIS weight toward the shading point.
            F = fs.num_triangles
            f0s = edges.f0[sel]
            f1s = edges.f1[sel]
            lid0 = fs.face_light_id[torch.clamp(f0s, 0, F - 1)]
            lid1 = torch.where(f1s >= 0,
                               fs.face_light_id[torch.clamp(f1s, 0, F - 1)],
                               torch.full_like(f1s, -1))
            lid = torch.maximum(lid0, lid1)
            ln = _face_normals(fs, torch.where(lid0 >= 0, f0s, f1s))
            geom_l = vm.safe_div(torch.abs(vm.dot(omega_sg, ln)),
                                 vm.maximum(dist * dist, 1e-12))
            lidc = torch.clamp(lid, 0, fs.num_area_lights - 1)
            pdf_nee = vm.safe_div(
                vm.safe_div(fs.light_pmf[lidc], fs.light_areas[lidc]), geom_l)
            pdf_b = bsdf_pdf_fn(omega_sg)
            ratio = vm.clip(vm.safe_div(pdf_nee, pdf_b, eps=1e-20), 0.0, 1e4)
            w_b = 1.0 / (1.0 + vm.square(ratio))
            diff_e = f_minus * E_minus - f_plus * E_plus
            diff_rest = diff_full - diff_e
            w_p_light = torch.sum(
                d_pixel * (w_b[:, None] * diff_e + diff_rest), dim=-1) * jac
            w_p = torch.where(lid >= 0, w_p_light, w_full)
        else:
            w_p = w_full

        live = active & has_cand
        w_ab = torch.where(live, w_full, 0.0)
        w_p = torch.where(live, w_p, 0.0)
        if SECONDARY_CLAMP_K > 0:
            # Clamp the gradient-scale proxy z = |w|/dist (the surrogate's
            # Jacobian scales as 1/dist) at CLAMP_K x a robust population
            # scale over this call's lanes.
            z = torch.where(live, torch.abs(w_ab) / vm.maximum(dist, 1e-6),
                            0.0)
            scale = firefly_scale(z, SECONDARY_CLAMP_K,
                                  lane_sharding=lane_sharding)
            w_ab = w_ab * scale
            w_p = w_p * scale

    # Two surrogate branches with the same direction and different gradient
    # destinations: the edge's vertices, and the shading point.
    av = fs.vertices[edges.v0[sel]]
    bv = fs.vertices[edges.v1[sel]]
    x_edge = (1.0 - t)[:, None] * av + t[:, None] * bv
    omega_ab = vm.normalize(x_edge - p_sg)
    omega_p = vm.normalize(x_sg - sp_position)
    return torch.sum(w_ab * vm.dot(n_hat, omega_ab)
                     + w_p * vm.dot(n_hat, omega_p))
