"""Textures with differentiable mipmaps and trilinear footprint filtering
(port of redner_tpu/texture.py; reference pyredner/texture.py:34-69 for the
mipmap build, src/texture.h:53-141,326-354 for the lookup).

A texture's mip levels are packed into one (total_texels, C) table with
per-level (width, height, offset) lists, so a per-lane fetch is 8 taps (two
bilinear footprints) into one flat table whatever the level.  Every tap is
a `torch.index_select` on that table: its backward is an atomic
`index_add_`, where `table[idx]`'s backward sorts the indices and adds each
run of duplicates serially.

`MaterialBank` packs every material's stacks into one such table, indexed
per lane through one int row per (stack, material).  The JAX package turns
small-table fetches into one-hot matmuls for the TPU's matrix unit; here
they are the same 8 taps as gathers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from redner_tpu_torch.core import vecmath as vm
from redner_tpu_torch.core.consts import const
from redner_tpu_torch.device import resolve_device

MAX_MIP_LEVELS = 8  # src/texture.h:11


@dataclass
class Texture:
    """User-facing texture: base texels + uv scale (pyredner/texture.py)."""

    texels: torch.Tensor  # (H, W, C), or (C,) for a constant
    uv_scale: torch.Tensor  # (2,)

    @property
    def is_constant(self):
        return self.texels.dim() == 1

    @property
    def channels(self):
        return self.texels.shape[-1]


def make_texture(texels, uv_scale=None, dtype=torch.float32,
                 device=None) -> Texture:
    dev = resolve_device(device)
    texels = torch.as_tensor(texels, dtype=dtype, device=dev)
    if uv_scale is None:
        uv_scale = torch.ones((2,), dtype=dtype, device=dev)
    else:
        uv_scale = torch.as_tensor(uv_scale, dtype=dtype, device=dev)
    return Texture(texels=texels, uv_scale=uv_scale)


def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize(..., "linear") along
    one axis: a triangle kernel widened by the downscale factor
    (antialias=True), normalised per output sample.  Computed in float32
    step by step as JAX does (jax/_src/image/scale.py compute_weight_mat),
    so the non-divisible mip levels match it to rounding."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _area_downsample(x, out_h: int, out_w: int):
    """Box average for exact halving; for sizes that do not divide, the
    antialiased linear resize of the JAX package (an explicit weight matrix
    per axis: F.interpolate's antialias weights are not the same)."""
    h, w, c = x.shape
    if h % out_h == 0 and w % out_w == 0:
        return x.reshape(out_h, h // out_h, out_w, w // out_w, c).mean(
            dim=(1, 3))
    if out_h != h:
        wh = const(lambda: _linear_resize_weights(h, out_h), x.dtype,
                   x.device, key=("resize", h, out_h))
        x = torch.einsum("hwc,hk->kwc", x, wh)
    if out_w != w:
        ww = const(lambda: _linear_resize_weights(w, out_w), x.dtype,
                   x.device, key=("resize", w, out_w))
        x = torch.einsum("hwc,wk->hkc", x, ww)
    return x


def build_mipmap(texels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Differentiable mipmap pyramid (pyredner/texture.py:34-69 semantics).

    Level l+1 = area-downsample(circular-pad 2x2 box filter(level l)).
    Returns a tuple of (H_l, W_l, C) tensors, at most MAX_MIP_LEVELS."""
    if texels.dim() == 1:
        return (texels,)
    h, w, _ = texels.shape
    width = max(h, w)
    num_levels = min(int(math.ceil(math.log2(max(width, 1)) + 1)),
                     MAX_MIP_LEVELS)
    levels = [texels]
    prev = texels
    for _ in range(1, num_levels):
        ph, pw = prev.shape[0], prev.shape[1]
        padded = torch.cat([prev, prev[:1]], dim=0)
        padded = torch.cat([padded, padded[:, :1]], dim=1)
        boxed = 0.25 * (padded[:-1, :-1] + padded[1:, :-1] + padded[:-1, 1:]
                        + padded[1:, 1:])
        prev = _area_downsample(boxed, max(ph // 2, 1), max(pw // 2, 1))
        levels.append(prev)
    return tuple(levels)


def _is_pow2(sizes) -> bool:
    return all(s > 0 and (s & (s - 1)) == 0 for s in sizes)


@dataclass
class PackedTexture:
    """A flattened mipmap pyramid ready for batched per-lane fetches."""

    flat: torch.Tensor  # (total_texels, C)
    uv_scale: torch.Tensor  # (2,)
    widths: Tuple[int, ...]
    heights: Tuple[int, ...]
    offsets: Tuple[int, ...]
    is_constant: bool
    # (3, num_levels) int64 on the texels' device: widths, heights, offsets.
    level_tab: Optional[torch.Tensor] = None

    @property
    def num_levels(self):
        return len(self.widths)

    @property
    def channels(self):
        return self.flat.shape[-1]

    @property
    def pow2(self):
        return _is_pow2(self.widths) and _is_pow2(self.heights)


def pack_texture(tex: Texture) -> PackedTexture:
    """Build and flatten the mipmap (differentiable w.r.t. tex.texels)."""
    if tex.is_constant:
        return PackedTexture(flat=tex.texels[None, :], uv_scale=tex.uv_scale,
                             widths=(0,), heights=(0,), offsets=(0,),
                             is_constant=True)
    widths, heights, offsets, flats = [], [], [], []
    off = 0
    for lvl in build_mipmap(tex.texels):
        h, w, c = lvl.shape
        widths.append(w)
        heights.append(h)
        offsets.append(off)
        off += h * w
        flats.append(lvl.reshape(h * w, c))
    return PackedTexture(
        flat=torch.cat(flats, dim=0), uv_scale=tex.uv_scale,
        widths=tuple(widths), heights=tuple(heights), offsets=tuple(offsets),
        is_constant=False,
        level_tab=const([widths, heights, offsets], torch.int64,
                        tex.texels.device))


def _wrap_mod(x, m, pow2: bool):
    """x mod m, floored as jnp.mod (torch.remainder; not torch.fmod), for
    per-lane m; a bitwise AND when every size is a power of two."""
    if pow2:
        return x & (m - 1)
    return torch.remainder(x, m)


def _bilinear_weights(wi, hi, off, pow2: bool, uv):
    """Flat indices (..., 4) and weights (..., 4) of the bilinear taps at
    per-lane level sizes wi, hi and texel offsets off, with wrap addressing
    (src/texture.h:66-76)."""
    x = uv[..., 0] * wi.to(uv.dtype) - 0.5
    y = uv[..., 1] * hi.to(uv.dtype) - 0.5
    xf = torch.floor(x)
    yf = torch.floor(y)
    u = x - xf
    v = y - yf
    xf = xf.to(torch.int64)
    yf = yf.to(torch.int64)
    xfi = _wrap_mod(xf, wi, pow2)
    yfi = _wrap_mod(yf, hi, pow2)
    xci = _wrap_mod(xf + 1, wi, pow2)
    yci = _wrap_mod(yf + 1, hi, pow2)
    idx = torch.stack([off + yfi * wi + xfi, off + yci * wi + xfi,
                       off + yfi * wi + xci, off + yci * wi + xci], dim=-1)
    w = torch.stack([(1 - u) * (1 - v), (1 - u) * v, u * (1 - v), u * v],
                    dim=-1)
    return idx, w


def _fetch(flat, idx, w):
    """sum_k w[..., k] * flat[idx[..., k]] with one index_select."""
    taps = flat.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (flat.shape[-1],))
    return torch.sum(taps * w[..., None], dim=-2)


def _mip_level(du, dv, w0, h0, top):
    """Trilinear level from the uv footprint: (li, ld) with li the lower
    integer level and ld the blend toward li + 1; top is the highest level
    (a float, or a per-lane tensor)."""
    # sqrt has an unbounded derivative at 0 (zero ray differentials are
    # common): floor the radicand so the chain rule sees a finite slope.
    footprint = torch.maximum(
        torch.sqrt(vm.maximum(torch.sum(du * du, dim=-1), 1e-20)) * w0,
        torch.sqrt(vm.maximum(torch.sum(dv * dv, dim=-1), 1e-20)) * h0,
    )
    level = vm.clip(torch.log2(vm.maximum(footprint, 1e-8)), 0.0, top)
    li = torch.floor(level).to(torch.int64)
    return li, (level - li.to(level.dtype))[..., None]


def texture_eval(ptex: PackedTexture, uv, du_dxy, dv_dxy):
    """Trilinear texture fetch (src/texture.h:326-354 semantics).

    uv: (..., 2); du_dxy/dv_dxy: (..., 2) screen-space uv derivatives.
    Returns (..., C)."""
    if ptex.is_constant:
        return ptex.flat[0].expand(uv.shape[:-1] + (ptex.channels,))
    uv = uv * ptex.uv_scale
    du = du_dxy * ptex.uv_scale[0]
    dv = dv_dxy * ptex.uv_scale[1]

    def taps(li):
        wi, hi, off = ptex.level_tab[:, li]
        return _bilinear_weights(wi, hi, off, ptex.pow2, uv)

    if ptex.num_levels == 1:
        idx, w = taps(torch.zeros(uv.shape[:-1], dtype=torch.int64,
                                  device=uv.device))
        return _fetch(ptex.flat, idx, w)
    li, ld = _mip_level(du, dv, float(ptex.widths[0]), float(ptex.heights[0]),
                        ptex.num_levels - 1 - 1e-6)
    idx0, w0 = taps(li)
    idx1, w1 = taps(li + 1)
    return _fetch(ptex.flat, torch.cat([idx0, idx1], dim=-1),
                  torch.cat([w0 * (1 - ld), w1 * ld], dim=-1))


# ------------------------------------------------------------------
# MaterialBank
# ------------------------------------------------------------------


@dataclass
class MaterialBank:
    """All materials' (stack, mip-pyramid) texel tables in ONE flat table,
    indexed per lane by (stack, material id): the reference's per-pixel
    material pointer fetch (src/texture.h:53-141), with a per-lane cost
    independent of the material count.

    tab rows (one per slot = stack*M + material, padded to Lmax levels):
      [num_levels, w_0..w_{Lmax-1}, h_0.., off_0..]  (1 + 3*Lmax,) int64
    with ABSOLUTE texel offsets into `flat`.  Constant textures are stored
    as single-level 1x1 tables, so no tap needs a per-material branch."""

    flat: torch.Tensor  # (total_texels, C)
    tab: torch.Tensor  # (num_slots, 1 + 3*Lmax) int64
    Lmax: int
    pow2: bool

    @property
    def channels(self):
        return self.flat.shape[-1]


def _bank_entry(ptex: Optional[PackedTexture], channels, Lmax, base, like):
    """(flat, int row, texel count) of one slot; `like` gives the dtype
    and device of an empty slot's zero texel."""
    if ptex is None:
        flat = torch.zeros((1, channels), dtype=like.dtype, device=like.device)
        w, h, off, nl = [1], [1], [0], 1
    elif ptex.is_constant:
        flat = ptex.flat
        w, h, off, nl = [1], [1], [0], 1
    else:
        flat = ptex.flat
        w, h, off = list(ptex.widths), list(ptex.heights), list(ptex.offsets)
        nl = ptex.num_levels
    if flat.shape[-1] < channels:
        flat = torch.cat([flat, torch.zeros(
            (flat.shape[0], channels - flat.shape[-1]), dtype=flat.dtype,
            device=flat.device)], dim=-1)
    pad = Lmax - len(w)
    row = ([nl] + w + [1] * pad + h + [1] * pad
           + [base + o for o in off] + [base] * pad)
    return flat, row, flat.shape[0]


def pack_material_bank(stacks) -> MaterialBank:
    """stacks: per-stack lists of Optional[PackedTexture] over all
    materials, e.g. [diffuse, specular, roughness, normal].  Channel counts
    pad to the largest (roughness' value lands in channel 0)."""
    present = [p for stack in stacks for p in stack if p is not None]
    channels = max([1] + [p.channels for p in present])
    Lmax = max([1] + [p.num_levels for p in present if not p.is_constant])
    flats, rows = [], []
    base = 0
    for stack in stacks:
        for p in stack:
            flat, row, n = _bank_entry(p, channels, Lmax, base, present[0].flat)
            flats.append(flat)
            rows.append(row)
            base += n
    sizes = [s for r in rows for s in r[1:1 + 2 * Lmax]]
    return MaterialBank(
        flat=torch.cat(flats, dim=0),
        tab=const(rows, torch.int64, present[0].flat.device),
        Lmax=Lmax, pow2=_is_pow2(sizes))


def _bank_level_select(tab_row, Lmax, li):
    """(w, h, off) of each lane's row at its integer level li: three
    gathers along the row (the JAX package's one-hot selects)."""
    col = li[..., None]
    return (torch.gather(tab_row, -1, 1 + col)[..., 0],
            torch.gather(tab_row, -1, 1 + Lmax + col)[..., 0],
            torch.gather(tab_row, -1, 1 + 2 * Lmax + col)[..., 0])


def _bank_bilinear_weights(bank: MaterialBank, tab_row, li, uv):
    """Flat indices + weights of the 4 bilinear taps at per-lane level."""
    wi, hi, off = _bank_level_select(tab_row, bank.Lmax, li)
    return _bilinear_weights(wi, hi, off, bank.pow2, uv)


def bank_eval(bank: MaterialBank, tab_row, uv, du_dxy, dv_dxy):
    """Trilinear fetch from the bank for pre-gathered table rows.

    tab_row: (..., 1+3*Lmax) int64, one row per lane (fetch_local_material
    gathers all stacks' rows at once); uv, du, dv are already scaled by the
    stack's uv scale."""
    nl = tab_row[..., 0]
    li, ld = _mip_level(du_dxy, dv_dxy, tab_row[..., 1].to(uv.dtype),
                        tab_row[..., 1 + bank.Lmax].to(uv.dtype),
                        vm.maximum(nl.to(uv.dtype) - 1 - 1e-6, 0.0))
    li1 = torch.minimum(li + 1, nl - 1)
    idx0, w0 = _bank_bilinear_weights(bank, tab_row, li, uv)
    idx1, w1 = _bank_bilinear_weights(bank, tab_row, li1, uv)
    return _fetch(bank.flat, torch.cat([idx0, idx1], dim=-1),
                  torch.cat([w0 * (1 - ld), w1 * ld], dim=-1))
