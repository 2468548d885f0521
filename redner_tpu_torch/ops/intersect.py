"""Batched ray-triangle intersection: the coefficient forms and the plain
PyTorch versions of the two ray-query kernels (port of
redner_tpu/ops/intersect.py).

The Moller-Trumbore solve for a (ray, triangle) pair is four scalar
products, each bilinear in per-ray features R = [d, d x org, org, 1] (10)
and per-triangle coefficients T (10, 4):

    [det, u_num, v_num, t_num] = R . T

followed by a division-free hit test (with s = sign(det), adet = |det|):
adet > 1e-8, s*u_num >= 0, s*v_num >= 0, s*(u_num + v_num) <= adet and
tmin*adet < s*t_num < tmax*adet; t = s*t_num / adet for hits.

`closest_plain` / `anyhit_plain` are the plain versions of the CUDA
kernels in ops/intersect_cuda.py (the sweep of accel.intersect/occluded
with engine="plain", and of any CPU tensor): they run over the same Morton-ordered
coefficient chunks and the same (tile, chunk) activity mask, in chunk
order, with strictly-smaller updates, so kernel and plain version can
differ only by floating-point rounding of the four products.
"""

from __future__ import annotations

import torch

from redner_tpu_torch.core import vecmath as vm

CHUNK = 512  # triangles per coefficient chunk (pallas_intersect.CHUNK)
TILE_N = 128  # rays per kernel block and activity-mask tile
MT_EPS = 1e-8


def triangle_coefficients(v0, v1, v2):
    """Per-triangle (C, 10, 4) coefficient blocks; columns give
    (det, u_num, v_num, t_num) when multiplied with the ray features."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = vm.cross(e1, e2)  # (C, 3)
    C = v0.shape[0]
    z3 = torch.zeros((C, 3), dtype=v0.dtype, device=v0.device)
    z1 = torch.zeros((C, 1), dtype=v0.dtype, device=v0.device)
    # det = (d x e2) . e1 = -d . n
    det_col = torch.cat([-n, z3, z3, z1], dim=-1)
    # t_num = org . n - v0 . n
    t_col = torch.cat([z3, z3, n, -torch.sum(v0 * n, -1, keepdim=True)], dim=-1)
    # u_num = (org - v0) . (d x e2) = -(d x org) . e2 - d . (e2 x v0)
    u_col = torch.cat([-vm.cross(e2, v0), -e2, z3, z1], dim=-1)
    # v_num = d . ((org - v0) x e1) = (d x org) . e1 - d . (v0 x e1)
    v_col = torch.cat([-vm.cross(v0, e1), e1, z3, z1], dim=-1)
    return torch.stack([det_col, u_col, v_col, t_col], dim=-1)  # (C, 10, 4)


def ray_features(org, d):
    """(N, 10) ray feature matrix [d, d x org, org, 1]."""
    one = torch.ones(d.shape[:-1] + (1,), dtype=d.dtype, device=d.device)
    return torch.cat([d, vm.cross(d, org), org, one], dim=-1)


def _exact_hit(terms, tmin, tmax):
    """Division-free hit test on (N, 4*CHUNK) terms -> (hit, t)."""
    det, u_num, v_num, t_num = torch.split(terms, CHUNK, dim=1)
    s = torch.where(det >= 0.0, 1.0, -1.0).to(det.dtype)
    adet = torch.abs(det)
    u = s * u_num
    v = s * v_num
    tn = s * t_num
    hit = (
        (adet > MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= adet)
        & (tn > tmin[:, None] * adet)
        & (tn < tmax[:, None] * adet)
    )
    t = torch.where(hit, tn / torch.clamp_min(adet, MT_EPS),
                    torch.full_like(tn, float("inf")))
    return hit, t


def closest_plain(Tc, rb):
    """Plain version of the closest-hit kernel.

    Tc: (nchunks, 10, 4*CHUNK) coefficients; rb: an intersect_cuda.RayBatch
    (padded features, tmin/tmax and the (ntile, nchunks) activity mask).
    Returns (best_t (Npad,), best_i (Npad,) sorted-triangle index or -1);
    tiles without an active chunk return inf / -1.
    """
    npad = rb.R.shape[0]
    dev = rb.R.device
    best_t = torch.full((npad,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((npad,), -1, dtype=torch.int64, device=dev)
    lane_tile = torch.arange(npad, device=dev) // TILE_N
    for c in range(Tc.shape[0]):
        act = rb.mask[lane_tile, c]
        _, t = _exact_hit(rb.R @ Tc[c], rb.tmin, rb.tmax)
        t = torch.where(act[:, None], t, torch.full_like(t, float("inf")))
        arg = torch.argmin(t, dim=1)  # first index among equal minima
        t_c = torch.gather(t, 1, arg[:, None])[:, 0]
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        best_i = torch.where(better, c * CHUNK + arg, best_i)
    return best_t, best_i


def anyhit_plain(Tc, rb):
    """Plain version of the any-hit kernel.

    Returns (blocked (Npad,) bool, steps (ntile,) int64): a tile visits its
    active chunks in order and stops once every lane in it is settled
    (blocked, dead or padding); steps counts the chunks it visited.
    """
    npad = rb.R.shape[0]
    dev = rb.R.device
    ntile = rb.mask.shape[0]
    blocked = torch.zeros((npad,), dtype=torch.bool, device=dev)
    steps = torch.zeros((ntile,), dtype=torch.int64, device=dev)
    dead = ~(rb.tmax >= rb.tmin)
    lane_tile = torch.arange(npad, device=dev) // TILE_N
    for c in range(Tc.shape[0]):
        tile_settled = (blocked | dead).reshape(ntile, TILE_N).all(dim=1)
        proc = rb.mask[:, c] & ~tile_settled
        steps += proc.to(torch.int64)
        hit, _ = _exact_hit(rb.R @ Tc[c], rb.tmin, rb.tmax)
        blocked = blocked | (hit.any(dim=1) & proc[lane_tile])
    return blocked, steps

