"""The two ray-query kernels on Hopper and the launcher code around them.

Replaces the Pallas TPU kernels of redner_tpu/ops/pallas_intersect.py:

  * closest hit: `_closest_kernel` (pallas_intersect.py:164), launched by
    `intersect_pallas` (:618, pl.pallas_call at :639);
  * any hit: `_anyhit_kernel` (:323), launched by `occluded_pallas` (:690,
    pl.pallas_call at :705).

The kernels themselves are CUDA C++ in csrc/intersect.cu, compiled for
sm_90a by nvcc into a shared library with a C interface at first use and
called through ctypes.  This module also holds what the Pallas launcher did
in XLA: the Morton-ordered coefficient layout with per-chunk AABBs
(`coeff_layout_build`), the per-tile chunk activity mask and its per-tile
CSR lists of active chunks, the optional Morton ray sort, and the
epilogue (sorted index -> triangle id -> shape id, inactive-tile masking,
undoing the ray sort).

`closest_hit` / `any_hit` take tensors on one device: on a CUDA tensor they
launch the kernel (a failed build or launch raises); on a CPU tensor they
run the plain version from ops/intersect.py.  Each counts its kernel
launches in LAUNCHES.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch

from redner_tpu_torch.core.types import Intersection
from redner_tpu_torch.ops.intersect import (CHUNK, TILE_N, anyhit_plain,
                                            closest_plain, ray_features,
                                            triangle_coefficients)

SORT_MIN_CHUNKS = 8  # the Morton ray sort pays off above this many chunks

# Kernel launches since the last reset_launch_counts(); the plain path on
# CPU tensors does not count.
LAUNCHES = {"closest_hit": 0, "any_hit": 0}

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR / "csrc" / "intersect.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib_handle = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# Build and bind
# ----------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("redner_tpu_torch: nvcc not found (set CUDA_HOME)")


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile csrc/intersect.cu for sm_90a into BUILD_DIR (once per source
    version).  Returns (library path, compiler output); verbose adds
    `-Xptxas -v` (registers, shared memory and spills per kernel) and
    forces a rebuild so the report is fresh."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libintersect_{tag}.so"
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"redner_tpu_torch: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _lib():
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # (R, tmin, tmax, Tc, tile_ptr, tile_chunks, ntile, out0, out1, stream)
        for fn in (lib.rt_closest_hit, lib.rt_any_hit):
            fn.argtypes = [p, p, p, p, p, p, i, p, p, p]
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
    idx_map: torch.Tensor  # (nchunks*CHUNK,) sorted slot -> triangle id
    cl_min: torch.Tensor  # (nchunks, 3) chunk AABB
    cl_max: torch.Tensor  # (nchunks, 3)

    @property
    def nchunks(self):
        return self.Tc.shape[0]


def coeff_layout_build(fs) -> CoeffLayout:
    """Morton-ordered coefficient chunks, per-chunk AABBs and the sorted
    triangle-id map.  The tail chunk is padded by repeating the last sorted
    triangle; a duplicate can never win a closest hit because updates are
    strictly-smaller and the original comes first."""
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
    T = T.reshape(nchunks, CHUNK, 10, 4).permute(0, 2, 3, 1)  # (nc, 10, 4, CHUNK)
    return CoeffLayout(
        Tc=T.reshape(nchunks, 10, 4 * CHUNK).contiguous(),
        idx_map=idx,
        cl_min=tri_min.min(dim=1).values,
        cl_max=tri_max.max(dim=1).values,
    )


# ----------------------------------------------------------------------
# Ray preparation (pallas_intersect.py:432-568)
# ----------------------------------------------------------------------


def _tile_chunk_mask(org, d, tmin, tmax, live, ntile, cl_min, cl_max,
                     tile=TILE_N):
    """(ntile, nchunks) bool: exact per-ray slab tests against the chunk
    AABBs, OR-reduced over each tile's lanes."""
    small = torch.where(d >= 0, 1e-20, -1e-20).to(d.dtype)
    safe_d = torch.where(live[:, None] & (torch.abs(d) > 1e-20), d, small)
    inv_d = 1.0 / safe_d
    t0 = (cl_min[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    t1 = (cl_max[None, :, :] - org[:, None, :]) * inv_d[:, None, :]
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)  # (N, C)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (
        (t_far >= t_near)
        & (t_far >= tmin[:, None])
        & (t_near <= tmax[:, None])
        & live[:, None]
    )
    return hit.reshape(ntile, tile, -1).any(dim=1)


def _active_lists(mask):
    """(ntile, nchunks) mask -> per-tile CSR lists of active chunks in
    increasing chunk order: (tile_ptr (ntile+1,), tile_chunks (nnz,)),
    int32.  Replaces the Pallas flat step table (pallas_intersect.py:458):
    each block walks its own list instead of a global sequential grid."""
    cnt = mask.sum(dim=1)
    tile_ptr = torch.zeros((mask.shape[0] + 1,), dtype=torch.int64,
                           device=mask.device)
    tile_ptr[1:] = torch.cumsum(cnt, dim=0)
    tile_chunks = torch.nonzero(mask)[:, 1]  # row-major: per tile, ascending
    return tile_ptr.to(torch.int32), tile_chunks.to(torch.int32)


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
    tile_ptr: torch.Tensor  # (ntile+1,) int32
    tile_chunks: torch.Tensor  # (nnz,) int32
    perm: Optional[torch.Tensor]  # (n,) kernel lane -> caller lane
    n: int
    batch: tuple

    @property
    def tile_active(self):
        return self.tile_ptr[1:] > self.tile_ptr[:-1]


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
    tile_ptr, tile_chunks = _active_lists(mask)
    # Dead lanes (zero direction) never hit (det == 0); tmax < tmin marks
    # them settled so any-hit tiles of dead lanes can leave early.
    tmax_k = torch.where(live_p, tmax_p, torch.full_like(tmax_p, -1.0))
    return RayBatch(
        R=ray_features(org_p, d_p).contiguous(),
        tmin=tmin_p.contiguous(), tmax=tmax_k.contiguous(), live=live,
        mask=mask, tile_ptr=tile_ptr, tile_chunks=tile_chunks, perm=perm,
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
# Kernel wrappers
# ----------------------------------------------------------------------


def _check_batch(Tc, rb):
    npad = rb.R.shape[0]
    ntile = npad // TILE_N
    for name, x, dtype, shape in (
        ("R", rb.R, torch.float32, (npad, 10)),
        ("tmin", rb.tmin, torch.float32, (npad,)),
        ("tmax", rb.tmax, torch.float32, (npad,)),
        ("Tc", Tc, torch.float32, (Tc.shape[0], 10, 4 * CHUNK)),
        ("tile_ptr", rb.tile_ptr, torch.int32, (ntile + 1,)),
        ("tile_chunks", rb.tile_chunks, torch.int32, rb.tile_chunks.shape),
    ):
        if x.device != rb.R.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rb.R.device}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ntile


def _launch(fn_name, Tc, rb, out0, out1):
    ntile = _check_batch(Tc, rb)
    chunks = rb.tile_chunks
    if chunks.numel() == 0:  # keep a valid pointer for the C interface
        chunks = torch.zeros((1,), dtype=torch.int32, device=rb.R.device)
    with torch.cuda.device(rb.R.device):
        stream = torch.cuda.current_stream(rb.R.device).cuda_stream
        err = getattr(_lib(), fn_name)(
            rb.R.data_ptr(), rb.tmin.data_ptr(), rb.tmax.data_ptr(),
            Tc.data_ptr(), rb.tile_ptr.data_ptr(), chunks.data_ptr(),
            ntile, out0.data_ptr(), out1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"redner_tpu_torch: {fn_name} launch failed "
                           f"(cudaError {err})")


def closest_hit(Tc, rb):
    """Closest hit per lane: (best_t (Npad,) f32, best_i (Npad,) sorted
    triangle index or -1).  CUDA tensors: the kernel; CPU: closest_plain."""
    if not rb.R.is_cuda:
        return closest_plain(Tc, rb)
    npad = rb.R.shape[0]
    best_t = torch.empty((npad,), dtype=torch.float32, device=rb.R.device)
    best_i = torch.empty((npad,), dtype=torch.int32, device=rb.R.device)
    if npad:
        _launch("rt_closest_hit", Tc, rb, best_t, best_i)
        LAUNCHES["closest_hit"] += 1
    return best_t, best_i


def any_hit(Tc, rb):
    """Any hit per lane: (blocked (Npad,), steps (ntile,) chunks each tile
    visited before it settled).  CUDA tensors: the kernel; CPU:
    anyhit_plain."""
    if not rb.R.is_cuda:
        return anyhit_plain(Tc, rb)
    npad = rb.R.shape[0]
    blocked = torch.empty((npad,), dtype=torch.int32, device=rb.R.device)
    steps = torch.empty((npad // TILE_N,), dtype=torch.int32,
                        device=rb.R.device)
    if npad:
        _launch("rt_any_hit", Tc, rb, blocked, steps)
        LAUNCHES["any_hit"] += 1
    return blocked, steps

