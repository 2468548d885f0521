"""The benchmark's arithmetic: the published peaks, the ray queries' work
bound, the reading of a device profile, the 95th percentile, and the
card's name and power limit (frozen from chip_smoke.py's work_bound,
profile_run and phase_device).

Nothing here imports the port: work_bound reads the fields of a launch's
inputs (the ray batch and the coefficient layout), whatever made them.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

PEAK_FP32_FLOPS = 67e12  # H100 SXM data sheet, FP32 outside tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
# FP32 operations of one ray-triangle test (redner_tpu_torch/csrc/
# intersect.cu test_tri): the 19 nonzero coefficients as 4 MUL + 15 FMA =
# 34 FLOP, then 14 more: sign(det), |det|, three sign scales, adet > eps,
# u >= 0, v >= 0, u + v, u + v <= adet, tmin*adet, tmax*adet and the two t
# compares.  The one division per hit is left out.
OPS_PER_TEST = 48
CHUNK = 512  # triangles per coefficient chunk of the kernels' layout
TILE_N = 128  # rays per tile of the kernels' activity mask
MT_EPS = 1e-8
SETTLE_BLOCK_TILES = 128  # tiles per block of anyhit_settle_steps


def _hits(R, Tc_chunk, tmin, tmax):
    """(rays, CHUNK) bool: the division-free hit test of the kernels."""
    terms = R @ Tc_chunk
    det, u_num, v_num, t_num = torch.split(terms, CHUNK, dim=1)
    s = torch.where(det >= 0.0, 1.0, -1.0).to(det.dtype)
    adet = torch.abs(det)
    u, v, tn = s * u_num, s * v_num, s * t_num
    return ((adet > MT_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= adet)
            & (tn > tmin[:, None] * adet) & (tn < tmax[:, None] * adet))


def anyhit_settle_steps(Tc, R, tmin, tmax, mask):
    """(ntile,) int64: the active chunks each tile of an any-hit launch
    visits before every lane in it is blocked, dead or padding (the
    kernel's early exit), computed from the launch's inputs in blocks of
    tiles.  Tc: (nchunks, 10, 4*CHUNK) coefficients."""
    ntile = mask.shape[0]
    out = []
    for t0 in range(0, ntile, SETTLE_BLOCK_TILES):
        t1 = min(t0 + SETTLE_BLOCK_TILES, ntile)
        lanes = slice(t0 * TILE_N, t1 * TILE_N)
        r, lo, hi, m = R[lanes], tmin[lanes], tmax[lanes], mask[t0:t1]
        nt = t1 - t0
        blocked = torch.zeros(r.shape[0], dtype=torch.bool, device=r.device)
        dead = ~(hi >= lo)
        steps = torch.zeros(nt, dtype=torch.int64, device=r.device)
        lane_tile = torch.arange(r.shape[0], device=r.device) // TILE_N
        for c in range(Tc.shape[0]):
            settled = (blocked | dead).reshape(nt, TILE_N).all(dim=1)
            proc = m[:, c] & ~settled
            steps += proc.to(torch.int64)
            blocked |= _hits(r, Tc[c], lo, hi).any(dim=1) & proc[lane_tile]
        out.append(steps)
    return torch.cat(out)


def work_bound(ntri, Tp_numel, R, tmin, tmax, live, mask, count,
               steps=None):
    """(bound_s, bound_by, tests) of one ray-query launch: the ray-triangle
    tests its inputs need (live lanes x real triangles of each active
    chunk; for any hit only the first `steps[tile]` active chunks, where
    the kernel stops) x OPS_PER_TEST over the FP32 peak, against each
    input read once and each output written once over the HBM rate.
    count: the launch's number of active (tile, chunk) pairs."""
    dev = mask.device
    ntile, nchunks = mask.shape
    real = torch.clamp(ntri - torch.arange(nchunks, device=dev) * CHUNK,
                       0, CHUNK)
    lv = torch.zeros(ntile * TILE_N, dtype=torch.int64, device=dev)
    lv[: live.shape[0]] = live.to(torch.int64)
    live_per_tile = lv.reshape(ntile, TILE_N).sum(dim=1)
    visited = mask
    if steps is not None:
        rank = torch.cumsum(mask.to(torch.int64), dim=1)
        visited = mask & (rank <= steps.to(torch.int64)[:, None])
    tris = (visited.to(torch.int64) * real).sum(dim=1)
    tests = int((tris * live_per_tile).sum())
    nbytes = 4 * (R.numel() + tmin.numel() + tmax.numel() + Tp_numel
                  + 2 * int(count) + 1 + 2 * R.shape[0])
    t_ops = tests * OPS_PER_TEST / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", tests)


def merge_intervals(intervals):
    """Sorted, merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_and_gaps(kernels, t0, t1):
    """Device busy seconds within [t0, t1] and the idle gaps there:
    kernels is [(name, start_s, end_s)] on one clock; the busy time is the
    union of the kernels' intervals, so kernels that overlap count once.
    Returns (busy_s, [(gap_start, gap_end)])."""
    iv = merge_intervals([(max(a, t0), min(b, t1)) for _, a, b in kernels
                          if b > t0 and a < t1])
    busy = sum(b - a for a, b in iv)
    gaps, prev = [], t0
    for a, b in iv:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    return busy, gaps


def idle_share(busy_s, window_s):
    """1 - busy/wall of a profiled window."""
    return 1.0 - busy_s / window_s


def p95(values):
    """The 95th percentile of every value (statistics.quantiles, exclusive
    method), over all of them: never over medians of chunks."""
    return statistics.quantiles(values, n=20)[18]


def device_line():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        out = smi.stdout.strip()
        return out.splitlines()[0] if out else smi.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
