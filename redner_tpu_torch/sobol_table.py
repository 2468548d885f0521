"""The direction-number table of the scrambled Sobol sampler and the
generator that made it (port of redner_tpu/sampler.py:161-385).

Dimension 0 is van der Corput; dims 1-20 take the Joe-Kuo initial values;
every later dim takes the next primitive polynomial over GF(2) and odd
initial direction numbers from a seeded draw, re-drawn until its pair
projections against the previous 7 dims pass an occupancy chi2 screen
(a pathological pair puts 4096 scrambled points on half a 16x16 grid).

The screen draws its points with the sampler's own scramble (torch on the
CPU), and the full 1024 dims take about 80 s on one CPU core, so the port
ships its output as `_sobol_table.npz` beside this file and
`load_sobol_table` reads that.  To rebuild the file:

    python -m redner_tpu_torch.sobol_table
"""

from __future__ import annotations

import os

import numpy as np
import torch

SOBOL_TABLE_DIMS = 1024
SOBOL_BITS = 32
TABLE_VERSION = 3
TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_sobol_table.npz")

# (s, a, [m...]) per dimension >= 1; dimension 0 is van der Corput.
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
]


def _gf2_mulmod(x: int, y: int, p: int, s: int) -> int:
    """Multiply GF(2) polynomials x*y modulo p (degree s)."""
    r = 0
    while y:
        if y & 1:
            r ^= x
        y >>= 1
        x <<= 1
    while r.bit_length() > s:
        r ^= p << (r.bit_length() - 1 - s)
    return r


def _gf2_powmod(base: int, e: int, p: int, s: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf2_mulmod(r, base, p, s)
        base = _gf2_mulmod(base, base, p, s)
        e >>= 1
    return r


def _prime_factors(n: int):
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _is_primitive(s: int, a: int) -> bool:
    """Is x^s + a_1 x^{s-1} + ... + a_{s-1} x + 1 primitive over GF(2)?
    `a` packs the interior coefficients a_1..a_{s-1} (Joe-Kuo encoding)."""
    p = (1 << s) | (a << 1) | 1
    n = (1 << s) - 1
    if n == 1:
        return True  # x + 1
    if _gf2_powmod(2, n, p, s) != 1:  # 2 encodes the polynomial `x`
        return False
    return all(_gf2_powmod(2, n // q, p, s) != 1 for q in _prime_factors(n))


def _generated_polys(n_extra: int):
    """(s, a) primitive polynomials for dims beyond the Joe-Kuo table, in
    (degree, a) order."""
    used = {(s, a) for (s, a, _) in _JOE_KUO}
    out, s = [], 1
    while len(out) < n_extra:
        for a in range(1 << max(s - 1, 0)):
            if (s, a) in used or not _is_primitive(s, a):
                continue
            used.add((s, a))
            out.append((s, a))
            if len(out) == n_extra:
                break
        s += 1
    return out


def _dim_row(s: int, a: int, m_init) -> np.ndarray:
    """(32,) uint32 direction numbers for one dimension."""
    m = list(m_init)
    for j in range(s, SOBOL_BITS):
        # m_j = 2^s m_{j-s} ^ m_{j-s} ^ XOR_k a_k 2^k m_{j-k}
        newm = m[j - s] ^ (m[j - s] << s)
        for k in range(1, s):
            if (a >> (s - 1 - k)) & 1:
                newm ^= m[j - k] << k
        m.append(newm)
    return np.array(
        [np.uint32(m[j]) << np.uint32(31 - j) for j in range(SOBOL_BITS)],
        np.uint32,
    )


def _scrambled(vrow, dim, seed, pixel=7, n=4096):
    """The sampler's scrambled uniforms of samples 0..n-1 at one pixel, with
    `vrow` as dimension `dim`'s direction numbers -> (n,) float64."""
    # The sampler imports this module for its table: import it here.
    from redner_tpu_torch import sampler

    idx_key = sampler._hash_u32(torch.tensor(
        ((seed * 0x9E3779B9) & 0xFFFFFFFF) ^ pixel, dtype=torch.int64))
    index = sampler._owen_scramble(torch.arange(n, dtype=torch.int64),
                                   idx_key)
    raw = torch.zeros_like(index)
    for j, v in enumerate(vrow.tolist()):
        raw ^= ((index >> j) & 1) * v
    val_key = sampler._hash_u32(idx_key ^ ((dim * 0x85EBCA6B) & 0xFFFFFFFF))
    return sampler._to_unit_float(
        sampler._owen_scramble(raw, val_key)).double().numpy()


def _pair_chi2(va, da, vb, db, seed, n=4096, g=16):
    u = _scrambled(va, da, seed, n=n)
    v = _scrambled(vb, db, seed, n=n)
    h, _, _ = np.histogram2d(u, v, bins=g, range=[[0, 1], [0, 1]])
    e = n / (g * g)
    return float(((h - e) ** 2 / e).sum())


# A pathological pair measures chi2 >= n = 4096 on the 16x16 grid; a
# healthy scrambled pair sits at or below the binomial expectation 255.
_SCREEN_CHI2 = 640.0
_SCREEN_WINDOW = 7  # dims consumed within a bounce block
_SCREEN_SEEDS = (0, 1)


def _screen_row(V, d, vrow):
    """Mean pair-chi2 of candidate row `vrow` for dim d against the
    previously accepted window; returns (ok, worst)."""
    worst = 0.0
    for b in range(max(1, d - _SCREEN_WINDOW), d):
        c = np.mean([_pair_chi2(vrow, d, V[b], b, s) for s in _SCREEN_SEEDS])
        worst = max(worst, c)
        if c > _SCREEN_CHI2:
            return False, worst
    return True, worst


def build_sobol_table(dims: int = SOBOL_TABLE_DIMS) -> np.ndarray:
    """(dims, 32) uint32 direction numbers (v_j scaled to 32 bits).  The
    generated dims are drawn and screened in order, so a build of fewer
    dims gives the first rows of the full table."""
    V = np.zeros((dims, SOBOL_BITS), np.uint32)
    for j in range(SOBOL_BITS):
        V[0, j] = np.uint32(1) << np.uint32(31 - j)
    for d, (s, a, m_init) in enumerate(_JOE_KUO[:dims - 1], start=1):
        V[d] = _dim_row(s, a, m_init)
    polys = _generated_polys(max(dims - 1 - len(_JOE_KUO), 0))
    rng = np.random.RandomState(0x5EED)
    for d, (s, a) in enumerate(polys, start=len(_JOE_KUO) + 1):
        best_row, best_chi = None, np.inf
        for _attempt in range(24):
            m = [2 * int(rng.randint(0, 1 << j)) + 1 for j in range(s)]
            row = _dim_row(s, a, m)
            ok, worst = _screen_row(V, d, row)
            if worst < best_chi:
                best_chi, best_row = worst, row
            if ok:
                break
        V[d] = best_row
    return V


def load_sobol_table() -> np.ndarray:
    """The shipped (SOBOL_TABLE_DIMS, 32) uint32 table."""
    with np.load(TABLE_PATH) as z:
        if int(z["version"]) != TABLE_VERSION or z["V"].shape != (
                SOBOL_TABLE_DIMS, SOBOL_BITS):
            raise ValueError(f"{TABLE_PATH}: not a version {TABLE_VERSION} "
                             f"({SOBOL_TABLE_DIMS}, {SOBOL_BITS}) table; "
                             "rebuild it with python -m "
                             "redner_tpu_torch.sobol_table")
        return z["V"].astype(np.uint32)


if __name__ == "__main__":
    np.savez(TABLE_PATH, V=build_sobol_table(),
             version=np.int64(TABLE_VERSION))
    print(f"wrote {TABLE_PATH}")
