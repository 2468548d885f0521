"""The two ray-query kernels on Hopper and the launcher code around them.

Replaces the Pallas TPU kernels of redner_tpu/ops/pallas_intersect.py:

  * closest hit: `_closest_kernel` (pallas_intersect.py:164), launched by
    `intersect_pallas` (:618, pl.pallas_call at :639);
  * any hit: `_anyhit_kernel` (:323), launched by `occluded_pallas` (:690,
    pl.pallas_call at :705).

The kernels themselves are CUDA C++ in csrc/intersect.cu, compiled for
sm_90a by nvcc into a shared library with a C interface at first use and
called through ctypes.  This module also holds what the Pallas launcher did
in XLA: the Morton-ordered coefficient layout with per-chunk AABBs and the
kernels' per-triangle packing (`coeff_layout_build`), the per-tile chunk
activity mask and its flat, rank-major list of active (tile, chunk) pairs
(the kernels' work list), the optional Morton ray sort, the closest-hit
merge key (`pack_hit_key` / `unpack_hit_key`), and the epilogue (sorted
index -> triangle id -> shape id, inactive-tile masking, undoing the ray
sort).

`closest_hit` / `any_hit` take tensors on one device: on a CUDA tensor they
launch the kernel (a failed build or launch raises); on a CPU tensor they
run the plain version from ops/intersect.py.  Each counts its kernel
launches in LAUNCHES, and with tracing on (timing.set_tracing) its work
in WORK: a device-side sum of each launch's active (tile, chunk) pairs,
which a CUDA graph's replays keep adding, and the lanes launched.  The
launch itself is the `kernel.closest_hit` / `kernel.any_hit` phase.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch

from redner_tpu_torch import timing
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.core.types import Intersection
from redner_tpu_torch.ops.intersect import (CHUNK, TILE_N, anyhit_plain,
                                            closest_plain, ray_features,
                                            triangle_coefficients)
from redner_tpu_torch.ops.nvcc import CSRC, build_library

SORT_MIN_CHUNKS = 8  # the Morton ray sort pays off above this many chunks
# Ray x chunk elements per block of the activity mask's slab tests.
MASK_BLOCK = 1 << 23

# Kernel launches since the last reset_launch_counts(); the plain path on
# CPU tensors does not count.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}

# Work of the launches made with tracing on, by kernel: "pairs", the
# active (tile, chunk) pairs summed on the device ({device: int64
# scalar}, made outside any capture, so graphs add into it); "lanes", the
# padded lanes launched (a graph adds its capture's at each replay); and
# "captured", the lanes of the launches recorded by captures, which run
# no kernel.
WORK = {"closest_hit": {"pairs": {}, "lanes": 0, "captured": 0},
        "any_hit": {"pairs": {}, "lanes": 0, "captured": 0}}

_SRC = CSRC / "intersect.cu"

_lib_handle = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count_work(kind, rb):
    """Adds a launch's pairs on the device and its lanes (tracing on); a
    captured launch's lanes go to "captured", for the graph's replays to
    count.  The sum is made at a kernel's first traced launch on a device,
    which an eager run makes before any capture of the same body; a launch
    captured before one (none of the port's routes) is not counted."""
    w = WORK[kind]
    capturing = torch.cuda.is_current_stream_capturing()
    acc = w["pairs"].get(rb.R.device)
    if acc is None:
        if capturing:
            return
        acc = w["pairs"][rb.R.device] = torch.zeros(
            (), dtype=torch.int64, device=rb.R.device)
    acc.add_(rb.count[0])
    w["captured" if capturing else "lanes"] += rb.R.shape[0]


def work_counts():
    """{kernel: (pairs, lanes)} of the traced launches so far (reads the
    device sums, so it waits for the card)."""
    return {k: (sum(int(a) for a in w["pairs"].values()), w["lanes"])
            for k, w in WORK.items()}


def reset_work_counts():
    """Zeros WORK in place (the graphs keep adding into the same sums)."""
    for w in WORK.values():
        for a in w["pairs"].values():
            a.zero_()
        w["lanes"] = 0


# ----------------------------------------------------------------------
# Build and bind
# ----------------------------------------------------------------------


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile csrc/intersect.cu for sm_90a into nvcc.BUILD_DIR (once per
    source version; nvcc.build_library).  Returns (library path, compiler
    output); verbose adds `-Xptxas -v` and forces a rebuild."""
    return build_library(_SRC, "intersect", verbose)


def _lib():
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # (R, tmin, tmax, Tp, pairs, capacity, count, ntri, counter, out,
        #  stream)
        for fn in (lib.rt_closest_hit, lib.rt_any_hit):
            fn.argtypes = [p, p, p, p, p, i, p, i, p, p, p]
            fn.restype = i
        _lib_handle = lib
    return _lib_handle


# ----------------------------------------------------------------------
# Coefficient layout (pallas_intersect._coeff_layout_build, :395-429)
# ----------------------------------------------------------------------


def _morton3(x):
    """Interleave 10-bit integer coords (..., 3) int64 -> 30-bit Morton
    codes (ops/cluster.py _morton3)."""
    def expand(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    return (expand(x[..., 0]) << 2) | (expand(x[..., 1]) << 1) | expand(x[..., 2])


@dataclass
class CoeffLayout:
    Tc: torch.Tensor  # (nchunks, 10, 4*CHUNK) f32, [det|u|v|t] column groups
    Tp: torch.Tensor  # (nchunks*CHUNK, PACK) f32, the kernels' packing
    idx_map: torch.Tensor  # (nchunks*CHUNK,) sorted slot -> triangle id
    cl_min: torch.Tensor  # (nchunks, 3) chunk AABB
    cl_max: torch.Tensor  # (nchunks, 3)
    ntri: int  # real triangles; sorted slots from ntri on are padding

    @property
    def nchunks(self):
        return self.Tc.shape[0]


# The kernels' per-triangle packing: (feature row k, column group g) of the
# 19 nonzero coefficients in the order csrc/intersect.cu reads them
# (bary_test, t_test; det: k 0-2; u and v: k 0-5; t: k 6-9), then one zero
# pad, so a triangle is five 16-byte rows.
PACK_ROWS = ([(k, 0) for k in range(3)] + [(k, 1) for k in range(6)]
             + [(k, 2) for k in range(6)] + [(k, 3) for k in range(6, 10)])
PACK = len(PACK_ROWS) + 1


def pack_coefficients(T):
    """(F', 10, 4) coefficient blocks -> (F', PACK) kernel rows."""
    k = const([r[0] for r in PACK_ROWS], torch.int64, T.device)
    g = const([r[1] for r in PACK_ROWS], torch.int64, T.device)
    return torch.cat([T[:, k, g], torch.zeros_like(T[:, :1, 0])], dim=1)


def coeff_layout_build(fs) -> CoeffLayout:
    """Morton-ordered coefficient chunks, per-chunk AABBs and the sorted
    triangle-id map.  The tail chunk is padded by repeating the last sorted
    triangle; a duplicate can never win a closest hit because updates are
    strictly-smaller and the original comes first (the kernels do not test
    the padding at all)."""
    verts = fs.vertices.detach()
    f = fs.faces
    F = f.shape[0]
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    centroid = (v0 + v1 + v2) / 3.0
    lo = torch.min(torch.minimum(torch.minimum(v0, v1), v2), dim=0).values
    hi = torch.max(torch.maximum(torch.maximum(v0, v1), v2), dim=0).values
    extent = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((centroid - lo) / extent * 1024.0, 0.0, 1023.0)
    order = torch.argsort(_morton3(q.to(torch.int64)), stable=True)

    nchunks = (F + CHUNK - 1) // CHUNK
    pad = nchunks * CHUNK - F
    idx = torch.cat([order, order[-1:].expand(pad)])
    sv0, sv1, sv2 = v0[idx], v1[idx], v2[idx]
    tri_min = torch.minimum(torch.minimum(sv0, sv1), sv2).reshape(nchunks, CHUNK, 3)
    tri_max = torch.maximum(torch.maximum(sv0, sv1), sv2).reshape(nchunks, CHUNK, 3)
    T = triangle_coefficients(sv0, sv1, sv2)  # (F', 10, 4)
    Tc = T.reshape(nchunks, CHUNK, 10, 4).permute(0, 2, 3, 1)  # (nc, 10, 4, CHUNK)
    return CoeffLayout(
        Tc=Tc.reshape(nchunks, 10, 4 * CHUNK).contiguous(),
        Tp=pack_coefficients(T).contiguous(),
        idx_map=idx,
        cl_min=tri_min.min(dim=1).values,
        cl_max=tri_max.max(dim=1).values,
        ntri=F,
    )


# ----------------------------------------------------------------------
# Ray preparation (pallas_intersect.py:432-568)
# ----------------------------------------------------------------------


def _tile_chunk_mask(org, d, tmin, tmax, live, ntile, cl_min, cl_max,
                     tile=TILE_N):
    """(ntile, nchunks) bool: exact per-ray slab tests against the chunk
    AABBs, OR-reduced over each tile's lanes.  The tests hold (rays,
    nchunks, 3) tensors, so they run over blocks of whole tiles of about
    MASK_BLOCK elements: per ray and per tile, the same result as one
    block."""
    rows = max(1, MASK_BLOCK // (cl_min.shape[0] * tile)) * tile
    if org.shape[0] > rows:
        return torch.cat([
            _tile_chunk_mask(org[i:i + rows], d[i:i + rows],
                             tmin[i:i + rows], tmax[i:i + rows],
                             live[i:i + rows], -(-min(rows, org.shape[0] - i)
                                                 // tile),
                             cl_min, cl_max, tile)
            for i in range(0, org.shape[0], rows)])
    small = torch.where(d >= 0, 1e-20, -1e-20).to(d.dtype)
    safe_d = torch.where(live[:, None] & (torch.abs(d) > 1e-20), d, small)
    inv_d = 1.0 / safe_d
    # A ray enters each axis's slab at the box's low side where it runs up
    # the axis and at its high side where it runs down: that side's
    # distance is min(t0, t1) of the two sides' (the difference and the
    # product by a nonzero inv_d keep their order), so each side is computed
    # alone, in one (rays, nchunks, 3) buffer, the largest of a ray query's
    # temporaries.
    up = (inv_d >= 0)[:, None, :]
    side = torch.where(up, cl_min[None, :, :], cl_max[None, :, :])
    side.sub_(org[:, None, :]).mul_(inv_d[:, None, :])
    t_near = torch.amax(side, dim=-1)  # (N, C)
    torch.where(up, cl_max[None, :, :], cl_min[None, :, :], out=side)
    side.sub_(org[:, None, :]).mul_(inv_d[:, None, :])
    t_far = torch.amin(side, dim=-1)
    hit = (
        (t_far >= t_near)
        & (t_far >= tmin[:, None])
        & (t_near <= tmax[:, None])
        & live[:, None]
    )
    return hit.reshape(ntile, tile, -1).any(dim=1)


def _active_lists(mask):
    """(ntile, nchunks) mask -> the kernels' work list, built without a
    host sync: (pairs, count).  pairs is (ntile * nchunks, 2) int32, its
    capacity; its first `count` rows ((1,) int32 on the mask's device) are
    the active (tile, chunk) pairs, rank-major (every tile's first active
    chunk, then every tile's second, ...; tiles ascending within a rank),
    so each tile's chunks come in increasing order.  The rows past count
    are in-range padding the kernels never read.  The pairs of the Pallas
    flat step table (pallas_intersect.py:458), which the kernels run in
    parallel instead of in sequence; the any-hit kernel's settling wants a
    tile's early chunks claimed first, the closest-hit merge is
    order-free.  An active pair's key is rank * ntile + tile, an inactive
    one's ntile * nchunks, past every active key."""
    ntile, nchunks = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    tile = torch.arange(ntile, device=mask.device)[:, None]
    key = torch.where(mask, rank * ntile + tile, ntile * nchunks)
    flat = torch.argsort(key.reshape(-1), stable=True)
    pairs = torch.stack([flat // nchunks, flat % nchunks], dim=1)
    count = mask.sum(dtype=torch.int32).reshape(1)
    return pairs.to(torch.int32).contiguous(), count


def _coherence_order(org, d, live):
    """Sort key packing origin Morton (6 bits/axis) over direction Morton
    (4 bits/axis); dead rays sort to the back."""
    big = torch.full_like(org, 3e38)
    o_lo = torch.where(live[:, None], org, big).amin(dim=0)
    o_hi = torch.where(live[:, None], org, -big).amax(dim=0)
    extent = torch.clamp_min(o_hi - o_lo, 1e-12)
    oq = torch.clamp((org - o_lo) / extent * 63.0, 0.0, 63.0).to(torch.int64)
    dq = torch.clamp((d * 0.5 + 0.5) * 15.0, 0.0, 15.0).to(torch.int64)
    key = (_morton3(oq) << 12) | _morton3(dq)
    key = torch.where(live, key, torch.full_like(key, 0xFFFFFFFF))
    return torch.argsort(key, stable=True)


@dataclass
class RayBatch:
    """Rays laid out for the kernels: padded to whole tiles, in kernel
    order (Morton-sorted when perm is set)."""

    R: torch.Tensor  # (Npad, 10) f32 ray features
    tmin: torch.Tensor  # (Npad,) f32
    tmax: torch.Tensor  # (Npad,) f32; padded and dead lanes hold -1
    live: torch.Tensor  # (n,) bool, kernel order
    mask: torch.Tensor  # (ntile, nchunks) bool activity mask
    pairs: torch.Tensor  # (ntile * nchunks, 2) int32 work list (_active_lists)
    count: torch.Tensor  # (1,) int32 on the device: active rows of pairs
    perm: Optional[torch.Tensor]  # (n,) kernel lane -> caller lane
    n: int
    batch: tuple

    @property
    def tile_active(self):
        return self.mask.any(dim=1)


def prepare_rays(fs, ray, presorted: bool = False):
    """Detach, optionally Morton-sort, pad and cull a batch of rays.

    presorted: the caller guarantees tile-coherent ray order (swizzled
    primary rays and their bounces), so the sort is skipped; it only runs
    above SORT_MIN_CHUNKS chunks anyway."""
    lay = fs.layout
    org = ray.org.detach().reshape(-1, 3)
    d = ray.dir.detach().reshape(-1, 3)
    tmin = ray.tmin.detach().reshape(-1)
    tmax = ray.tmax.detach().reshape(-1)
    perm = None
    if lay.nchunks > SORT_MIN_CHUNKS and not presorted:
        perm = _coherence_order(org, d, torch.sum(d * d, dim=-1) > 0)
        packed = torch.cat([org, d, tmin[:, None], tmax[:, None]], dim=-1)[perm]
        org, d, tmin, tmax = packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7]
    n = org.shape[0]
    live = torch.sum(d * d, dim=-1) > 0
    ntile = (n + TILE_N - 1) // TILE_N
    pad = ntile * TILE_N - n

    def padv(x, fill):
        if pad == 0:
            return x
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    org_p = padv(org, 0.0)
    d_p = padv(d, 0.0)
    live_p = padv(live, False)
    tmin_p = padv(tmin, 0.0)
    tmax_p = padv(tmax, -1.0)  # padded rays hit nothing
    mask = _tile_chunk_mask(org_p, d_p, tmin_p, tmax_p, live_p, ntile,
                            lay.cl_min, lay.cl_max)
    # Dead lanes (zero direction) never hit (det == 0); tmax < tmin marks
    # them settled so any-hit tiles of dead lanes can leave early.
    tmax_k = torch.where(live_p, tmax_p, torch.full_like(tmax_p, -1.0))
    pairs, count = _active_lists(mask)
    return RayBatch(
        R=ray_features(org_p, d_p).contiguous(),
        tmin=tmin_p.contiguous(), tmax=tmax_k.contiguous(), live=live,
        mask=mask, pairs=pairs, count=count, perm=perm,
        n=n, batch=tuple(ray.org.shape[:-1]),
    )


# ----------------------------------------------------------------------
# Epilogue (pallas_intersect.py:656-681, :715-721)
# ----------------------------------------------------------------------


def _unsort(rb, x, fill):
    if rb.perm is None:
        return x
    out = torch.full_like(x, fill)
    out[rb.perm] = x
    return out


def finish_closest(fs, rb, best_t, best_i) -> Intersection:
    """Sorted index -> triangle id -> shape id; masks inactive tiles and dead
    lanes; undoes the ray sort."""
    n = rb.n
    idx_map = fs.layout.idx_map
    act_ray = rb.tile_active.repeat_interleave(TILE_N)[:n]
    best_t = best_t[:n]
    best_i = best_i[:n].to(torch.int64)
    found = torch.isfinite(best_t) & (best_i >= 0) & rb.live & act_ray
    minus1 = torch.full_like(best_i, -1)
    tri = torch.where(found, idx_map[best_i.clamp(0, idx_map.shape[0] - 1)],
                      minus1)
    shape_id = torch.where(
        found, fs.face_shape_id[tri.clamp(0, fs.num_triangles - 1)], minus1)
    t_out = torch.where(found, best_t, torch.full_like(best_t, float("inf")))
    return Intersection(
        tri_id=_unsort(rb, tri, -1).reshape(rb.batch),
        shape_id=_unsort(rb, shape_id, -1).reshape(rb.batch),
        t=_unsort(rb, t_out, float("inf")).reshape(rb.batch),
    )


def finish_anyhit(rb, blocked) -> torch.Tensor:
    n = rb.n
    act_ray = rb.tile_active.repeat_interleave(TILE_N)[:n]
    blocked = (blocked[:n] != 0) & rb.live & act_ray
    return _unsort(rb, blocked, False).reshape(rb.batch)


# ----------------------------------------------------------------------
# Closest-hit merge key
# ----------------------------------------------------------------------

# One int64 per lane that the closest-hit kernel merges with atomicMin:
# order-preserving bits of t (as a signed int32, -0 taken as +0) in the
# high word, the sorted triangle index in the low word, so a smaller key is
# a smaller t and, at equal t, the lower index (the earliest (chunk,
# index), the tie rule of the Pallas kernel and of closest_plain).
# csrc/intersect.cu pack_key computes the same key.
NO_HIT = 2**63 - 1  # above every key: the fill of lanes with no hit


def pack_hit_key(t, idx):
    """(best_t f32, sorted index >= 0) -> int64 merge keys."""
    b = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = torch.where(b == -2**31, torch.zeros_like(b), b)
    b = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return b * 2**32 + idx.to(torch.int64)


def unpack_hit_key(key):
    """int64 merge keys -> (best_t f32, best_i int32), inf / -1 where
    the key is NO_HIT."""
    hit = key != NO_HIT
    hi = key >> 32
    b = torch.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).to(torch.int32)
    t = torch.where(hit, b.view(torch.float32), float("inf"))
    i = torch.where(hit, (key & 0xFFFFFFFF).to(torch.int32),
                    torch.full_like(b, -1))
    return t, i


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _launch(fn_name, lay, rb, out):
    """Checks the inputs and launches one kernel over rb's work list (its
    capacity of rows, of which the kernel reads rb.count on the device)
    into out: int64 keys filled with NO_HIT (closest hit) or int32 zeros
    (any hit).  A count of 0 is a launch that does no work."""
    npad = rb.R.shape[0]
    out_dtype = torch.int64 if fn_name == "rt_closest_hit" else torch.int32
    for name, x, dtype, shape in (
        ("R", rb.R, torch.float32, (npad, 10)),
        ("tmin", rb.tmin, torch.float32, (npad,)),
        ("tmax", rb.tmax, torch.float32, (npad,)),
        ("Tp", lay.Tp, torch.float32, (lay.nchunks * CHUNK, PACK)),
        ("pairs", rb.pairs, torch.int32,
         ((npad // TILE_N) * lay.nchunks, 2)),
        ("count", rb.count, torch.int32, (1,)),
        ("out", out, out_dtype, (npad,)),
    ):
        if x.device != rb.R.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rb.R.device}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % (4 if name == "count"
                                                    else 16):
            raise ValueError(f"{name} must be contiguous and aligned")
    if npad % TILE_N:
        raise ValueError(f"{npad} rays are not whole tiles of {TILE_N}")
    counter = torch.zeros((1,), dtype=torch.int32, device=rb.R.device)
    kind = "closest_hit" if fn_name == "rt_closest_hit" else "any_hit"
    with timing.phase("kernel." + kind, rb.R.device), \
            torch.cuda.device(rb.R.device):
        stream = torch.cuda.current_stream(rb.R.device).cuda_stream
        err = getattr(_lib(), fn_name)(
            rb.R.data_ptr(), rb.tmin.data_ptr(), rb.tmax.data_ptr(),
            lay.Tp.data_ptr(), rb.pairs.data_ptr(), rb.pairs.shape[0],
            rb.count.data_ptr(), lay.ntri, counter.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"redner_tpu_torch: {fn_name} launch failed "
                           f"(cudaError {err})")


def closest_hit(lay, rb):
    """Closest hit per lane of layout lay: (best_t (Npad,) f32, best_i
    (Npad,) sorted triangle index or -1).  CUDA tensors: the kernel (one
    launch, which does no work when no (tile, chunk) pair is active); CPU:
    closest_plain."""
    if not rb.R.is_cuda:
        return closest_plain(lay.Tc, rb)
    keys = torch.full((rb.R.shape[0],), NO_HIT, dtype=torch.int64,
                      device=rb.R.device)
    _launch("rt_closest_hit", lay, rb, keys)
    LAUNCHES["closest_hit"] += 1
    if timing.get_tracing():
        _count_work("closest_hit", rb)
    return unpack_hit_key(keys)


def any_hit(lay, rb):
    """Any hit per lane of layout lay: blocked (Npad,), nonzero where the
    segment is blocked.  CUDA tensors: the kernel (one launch, which does
    no work when no (tile, chunk) pair is active); CPU: anyhit_plain."""
    if not rb.R.is_cuda:
        return anyhit_plain(lay.Tc, rb)[0]
    blocked = torch.zeros((rb.R.shape[0],), dtype=torch.int32,
                          device=rb.R.device)
    _launch("rt_any_hit", lay, rb, blocked)
    LAUNCHES["any_hit"] += 1
    if timing.get_tracing():
        _count_work("any_hit", rb)
    return blocked
