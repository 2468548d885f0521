"""Counter-based, replay-exact random numbers (port of the independent
sampler of redner_tpu/sampler.py).

Every uniform is a pure function u(seed, pixel, sample_id, dim) of the
PCG4D hash (Jarzynski & Olano, JCGT 2020), so matched seeds draw the same
bits in both packages and no torch.Generator is involved.

uint32 arithmetic is carried in int64 holding values in [0, 2^32): every
product is split into 16-bit halves so no intermediate leaves int64, and
every result is masked back to 32 bits.
"""

from __future__ import annotations

import enum

import torch


class SamplerType(enum.Enum):
    independent = 0
    sobol = 1


# Dimension layout per path vertex, matching src/sampler.h:14-23.
CAMERA_DIMS = 2
LIGHT_DIMS = 4
BSDF_DIMS = 3
PRIMARY_EDGE_DIMS = 2
SECONDARY_EDGE_DIMS = 4
EDGE_SEED_OFFSET = 131071  # src/pathtracer.cpp:220-227

_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors holding uint32 values."""
    lo = (a & 0xFFFF) * b  # < 2^48
    hi = ((a >> 16) * (b & 0xFFFF)) << 16  # < 2^48
    return (lo + hi) & _M32


def _pcg4d(a, b, c, d):
    """PCG4D hash of four uint32 (as int64) tensors -> four uint32 tensors."""
    mul = 1664525
    inc = 1013904223
    a = (_mul32(a, mul) + inc) & _M32
    b = (_mul32(b, mul) + inc) & _M32
    c = (_mul32(c, mul) + inc) & _M32
    d = (_mul32(d, mul) + inc) & _M32
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    return a, b, c, d


def _to_unit_float(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _as_u32(x, device):
    """Any int (or int tensor, negative values wrapping) -> int64 uint32."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _device_of(*xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def uniform(seed, pixel_id, sample_id, dim):
    """One uniform in [0,1) per lane.  Args: broadcastable ints/tensors."""
    dev = _device_of(pixel_id, sample_id, seed, dim)
    a, _, _, _ = _pcg4d(*torch.broadcast_tensors(
        *(_as_u32(x, dev) for x in (seed, pixel_id, sample_id, dim))))
    return _to_unit_float(a)


def uniforms(seed, pixel_id, sample_id, dim_start, n_dims):
    """(pixels..., n_dims) uniforms for dims [dim_start, dim_start + n_dims).

    One hash per group of 4 dims, using all four of its outputs."""
    dev = _device_of(pixel_id, sample_id, seed)
    seed = _as_u32(seed, dev)
    pixel_id = _as_u32(pixel_id, dev)
    sample_id = _as_u32(sample_id, dev)
    outs = []
    for group in range(0, n_dims, 4):
        d = _as_u32(dim_start + group, dev)
        hashed = _pcg4d(*torch.broadcast_tensors(seed, pixel_id, sample_id, d))
        for w in hashed[: min(4, n_dims - group)]:
            outs.append(_to_unit_float(w))
    return torch.stack(outs, dim=-1)


class DimAllocator:
    """Tracks the running sample dimension, mirroring the reference sampler's
    per-sample dimension counter (src/sobol_sampler.cpp:97-115)."""

    def __init__(self):
        self.dim = 0

    def next(self, n):
        d = self.dim
        self.dim += n
        return d


def draw(sampler_type: SamplerType, seed, pixel_id, sample_id, dim_start,
         n_dims):
    """Per-stage uniforms for the requested sampler
    (reference src/sampler.h:10-24 dispatch)."""
    if sampler_type == SamplerType.sobol:
        raise NotImplementedError(
            "redner_tpu_torch: the Sobol sampler is not ported yet "
            "(ROADMAP queue A)")
    return uniforms(seed, pixel_id, sample_id, dim_start, n_dims)
