"""Counter-based, replay-exact random numbers (port of
redner_tpu/sampler.py): the independent sampler and the Owen-scrambled
Sobol sampler.

Every uniform is a pure function u(seed, pixel, sample_id, dim): of the
PCG4D hash (Jarzynski & Olano, JCGT 2020) for the independent sampler, of
the scrambled Sobol point for the Sobol sampler.  Matched seeds draw the
same bits in both packages and no torch.Generator is involved.

uint32 arithmetic is carried in int64 holding values in [0, 2^32): every
product is split into 16-bit halves so no intermediate leaves int64, and
every result is masked back to 32 bits.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from redner_tpu_torch.core.consts import const
from redner_tpu_torch.sobol_table import (SOBOL_BITS, SOBOL_TABLE_DIMS,
                                          load_sobol_table)


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
    """Any int (or int tensor, negative values wrapping) -> int64 uint32.
    An int becomes a device fill: a copy from the host would sync it, and
    could not be captured in a CUDA graph."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.full((), int(x) & _M32, dtype=torch.int64, device=device)


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


# ----------------------------------------------------------------------
# Scrambled Sobol (reference src/sobol_sampler.cpp): the sample index is
# sample_id, shuffled per (seed, pixel) by an Owen scramble; the value is
# Owen-scrambled per (seed, pixel, dim).  Dimensions past the table fall
# back to the hash (`uniform`).
# ----------------------------------------------------------------------


def _hash_u32(x):
    """A strong uint32 mix (hash64shift-style)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _reverse_bits(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def _owen_scramble(x, key):
    """Laine-Karras-style nested uniform scramble in reversed-bit space."""
    x = (_reverse_bits(x) + key) & _M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return _reverse_bits(x)


def _sobol_planes(device):
    """planes[d, j, k] = bit k of direction number j of dimension d, as
    float32 (0 or 1): the shipped table, read on first use, kept per
    device."""
    def planes():
        bits = (load_sobol_table().astype(np.int64)[..., None]
                >> np.arange(SOBOL_BITS)) & 1
        return bits.astype(np.float32)

    return const(planes, torch.float32, device, key="sobol_planes")


def _sobol_raw(index, dims):
    """Unscrambled 32-bit Sobol values of `index` (int64 holding uint32) at
    the table dimensions `dims` -> index.shape + (len(dims),).

    The XOR over the set bits of the index is the parity of a sum: the
    (n, 32) bit matrix times each dimension's (32, 32) bit planes, a
    product of 0/1 float32 entries whose sums (at most 32) are exact, then
    mod 2.  One matmul for all dims instead of 32 shift-and-XOR steps per
    dim."""
    # dims are consecutive: a slice, not an index tensor from the host.
    planes = _sobol_planes(index.device)[dims[0]:dims[-1] + 1]  # (D, 32, 32)
    D = planes.shape[0]
    shifts = torch.arange(SOBOL_BITS, device=index.device)
    bits = ((index.reshape(-1, 1) >> shifts) & 1).to(torch.float32)
    sums = bits @ planes.permute(1, 0, 2).reshape(SOBOL_BITS, D * SOBOL_BITS)
    out_bits = torch.remainder(sums, 2.0).to(torch.int64).reshape(
        -1, D, SOBOL_BITS)
    raw = torch.sum(out_bits << shifts, dim=-1)
    return raw.reshape(index.shape + (D,))


def sobol_uniforms(seed, pixel_id, sample_id, dim_start: int, n_dims: int):
    """(lanes..., n_dims) Owen-scrambled Sobol uniforms for the dims
    [dim_start, dim_start + n_dims); bit-equal to calling sobol_uniform per
    dim, with the index scramble and the table lookup shared by all dims."""
    dev = _device_of(pixel_id, sample_id, seed)
    seed = _as_u32(seed, dev)
    pixel_id = _as_u32(pixel_id, dev)
    sample_id = _as_u32(sample_id, dev)
    dims = list(range(dim_start, dim_start + n_dims))
    table = [d for d in dims if d < SOBOL_TABLE_DIMS]
    shape = torch.broadcast_shapes(seed.shape, pixel_id.shape,
                                   sample_id.shape)
    cols = {}
    if table:
        idx_key = _hash_u32(_mul32(seed, 0x9E3779B9) ^ pixel_id)
        index = _owen_scramble(sample_id, idx_key)
        raw = _sobol_raw(index, table)
        dkey = const(tuple((d * 0x85EBCA6B) & _M32 for d in table),
                     torch.int64, dev)
        val_key = _hash_u32(idx_key[..., None] ^ dkey)
        vals = _to_unit_float(_owen_scramble(raw, val_key))
        vals = vals.expand(shape + (len(table),))
        for k, d in enumerate(table):
            cols[d] = vals[..., k]
    for d in dims:
        if d >= SOBOL_TABLE_DIMS:
            cols[d] = uniform(seed, pixel_id, sample_id, d).expand(shape)
    return torch.stack([cols[d] for d in dims], dim=-1)


def sobol_uniform(seed, pixel_id, sample_id, dim: int):
    """One Owen-scrambled Sobol uniform per lane at dimension `dim` (a
    Python int); past the table, the hash's `uniform`."""
    return sobol_uniforms(seed, pixel_id, sample_id, dim, 1)[..., 0]


def draw(sampler_type: SamplerType, seed, pixel_id, sample_id, dim_start,
         n_dims):
    """Per-stage uniforms for the requested sampler
    (reference src/sampler.h:10-24 dispatch)."""
    if sampler_type == SamplerType.sobol:
        return sobol_uniforms(seed, pixel_id, sample_id, dim_start, n_dims)
    return uniforms(seed, pixel_id, sample_id, dim_start, n_dims)
