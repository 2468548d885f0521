"""Minimal pure-Python OpenEXR codec (a copy of redner_tpu/io/exr.py; the
port keeps its own so that it imports nothing of the JAX package).

The port reads and writes EXR through this codec alone, so no
OpenEXR-capable image library is needed (reference pyredner/image.py relies
on OpenEXR-capable imageio).

Supported:
  * read — scanline images, compression NONE (0), ZIPS (2), ZIP (3) and
    PIZ; channel types HALF and FLOAT; lineOrder increasing or decreasing;
    arbitrary channel sets (R/G/B[/A] mapped to the output order, other
    sets returned alphabetically).
  * write — float32 RGB(A)/single-channel, compression ZIP or NONE.

Format reference: the OpenEXR 2.0 file layout (openexr.com) — magic,
versioned header of named attributes, a scanline-offset table, then
per-chunk [y, byte_count, channel-interleaved rows].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_HALF, _FLOAT, _UINT = 1, 2, 0


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def _zip_do(raw: bytes) -> bytes:
    """EXR zip pre-processing (inverse of _zip_undo): interleave-split
    the bytes into halves, then delta-encode (+128 bias)."""
    b = np.frombuffer(raw, np.uint8)
    n = b.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = b[0::2]
    t[half:] = b[1::2]
    d = t.astype(np.int16)
    d[1:] = d[1:] - t[:-1].astype(np.int16) + 128
    return d.astype(np.uint8).tobytes()


def write_exr(path: str, img, compression: str = "zip") -> None:
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) float32 data.

    compression: "zip" (16-scanline zlib chunks, the default — matches
    what the reference's imageio/OpenEXR backend writes,
    pyredner/image.py:1-71), "zips" (1-scanline), or "none"."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    order = sorted(range(c), key=lambda i: names[i])  # file order: alpha
    comp_id, lines_per_chunk = {
        "none": (0, 1), "zips": (2, 1), "zip": (3, 16)
    }[compression]

    chlist = b""
    for i in order:
        chlist += (names[i].encode() + b"\0" + struct.pack("<i", _FLOAT)
                   + b"\0\0\0\0" + struct.pack("<ii", 1, 1))
    chlist += b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", bytes([comp_id]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\0")  # increasing y
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    head = _MAGIC + struct.pack("<i", 2) + header
    n_chunks = -(-h // lines_per_chunk)
    chunks = []
    for ci in range(n_chunks):
        y0c = ci * lines_per_chunk
        ny = min(lines_per_chunk, h - y0c)
        raw = b"".join(
            np.concatenate([img[y0c + li, :, i] for i in order])
            .astype("<f4").tobytes()
            for li in range(ny)
        )
        if comp_id:
            enc = zlib.compress(_zip_do(raw))
            if len(enc) >= len(raw):  # EXR stores whichever is smaller
                enc = raw
        else:
            enc = raw
        chunks.append(struct.pack("<ii", y0c, len(enc)) + enc)
    data_pos = len(head) + 8 * n_chunks
    offsets = []
    pos = data_pos
    for chk in chunks:
        offsets.append(pos)
        pos += len(chk)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        for chk in chunks:
            f.write(chk)


def _zip_undo(raw: bytes) -> bytes:
    """EXR zip post-processing: un-delta then de-interleave halves."""
    d = np.frombuffer(raw, np.uint8).astype(np.int16)
    d[1:] = d[1:] - 128
    d = np.cumsum(d, dtype=np.int64).astype(np.uint8)
    n = d.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


# ----------------------------------------------------------------------
# PIZ decompression (the OpenEXR default codec): 16-bit wavelet +
# canonical Huffman, per the public OpenEXR format spec (the
# ImfPizCompressor / ImfHuf / ImfWav algorithms).  HALF channels only —
# enough for the reference fixtures (tests/sunsky.exr).
# ----------------------------------------------------------------------

_HUF_ENCSIZE = (1 << 16) + 1


class _Bits:
    """MSB-first bit reader over a bytes object.

    Reads slice only the bytes spanning the request (O(l) per get) —
    production-sized PIZ chunks make any whole-buffer shifting
    quadratic."""

    def __init__(self, data: bytes):
        self._d = data
        self._n = len(data) * 8
        self.pos = 0

    def get(self, l: int) -> int:
        end = self.pos + l
        if end > self._n:
            raise IOError("EXR/PIZ: bitstream exhausted")
        first = self.pos >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(self._d[first:last], "big")
        out = (chunk >> (last * 8 - end)) & ((1 << l) - 1)
        self.pos = end
        return out


def _huf_unpack_lengths(bits: _Bits, im: int, iM: int) -> np.ndarray:
    """6-bit-packed code lengths with zero-run codes (hufUnpackEncTable)."""
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = bits.get(6)
        if l == 63:  # LONG_ZEROCODE_RUN
            # SHORTEST_LONG_RUN = 2 + LONG(63) - SHORT(59) = 6
            i += bits.get(8) + 6
        elif l >= 59:  # SHORT_ZEROCODE_RUN
            i += l - 59 + 2
        else:
            lengths[i] = l
            i += 1
    if i != iM + 1:
        raise IOError("EXR/PIZ: corrupt Huffman table")
    return lengths


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values from lengths (hufCanonicalCodeTable)."""
    n = np.zeros(59, np.int64)
    for l in lengths:
        if l > 0:
            n[l] += 1
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        first[i] = c
        c = nc
    codes = np.zeros(lengths.shape[0], np.int64)
    nxt = first.copy()
    for sym in np.nonzero(lengths)[0]:
        l = lengths[sym]
        codes[sym] = nxt[l]
        nxt[l] += 1
    return codes


_HUF_DECBITS = 14  # fast-table width (OpenEXR ImfHuf HUF_DECBITS)


def _huf_decode(bits: _Bits, end_bit: int, lengths, codes, rlc, n_out):
    """Table-driven canonical-prefix decode with the rlc run-length code.

    Codes of length <= 14 bits (in practice all of them) resolve in one
    lookup against a 2^14-entry (symbol, length) table built from the
    canonical code set — the OpenEXR hufBuildDecTable/hufDecode scheme.
    Longer codes fall back to a dict probe per length.  The bitstream is
    consumed through a bulk-refilled accumulator (one bytes index per 8
    bits), not per-bit reads: a production-sized envmap decodes in
    seconds instead of hours."""
    syms = np.nonzero(lengths)[0]
    fast_sym = np.full(1 << _HUF_DECBITS, -1, np.int32)
    fast_len = np.zeros(1 << _HUF_DECBITS, np.uint8)
    slow = {}
    for sym in syms:
        l = int(lengths[sym])
        c = int(codes[sym])
        if l <= _HUF_DECBITS:
            lo = c << (_HUF_DECBITS - l)
            span = 1 << (_HUF_DECBITS - l)
            fast_sym[lo : lo + span] = sym
            fast_len[lo : lo + span] = l
        else:
            slow[(l, c)] = int(sym)
    fast_sym = fast_sym.tolist()  # list indexing beats numpy scalar reads
    fast_len = fast_len.tolist()
    data = bits._d
    if bits.pos & 7:
        raise IOError("EXR/PIZ: Huffman data not byte-aligned")
    bytei = bits.pos >> 3
    nbytes = min(len(data), (end_bit + 7) >> 3)
    used = bits.pos  # absolute bits consumed by decoded symbols
    acc = 0
    alen = 0
    out = []
    push = out.append
    rlc = int(rlc)
    while len(out) < n_out:
        # Refill: keep >= 58 lookahead bits when available (max code 58,
        # + 8 run bits).  Zero-fill past the stream end matches the
        # encoder's final-byte padding.
        while alen <= 56 and bytei < nbytes:
            acc = (acc << 8) | data[bytei]
            bytei += 1
            alen += 8
        if used >= end_bit:
            raise IOError("EXR/PIZ: Huffman data exhausted")
        if alen >= _HUF_DECBITS:
            peek = (acc >> (alen - _HUF_DECBITS)) & 0x3FFF
        else:
            peek = (acc << (_HUF_DECBITS - alen)) & 0x3FFF
        l = fast_len[peek]
        if l:
            sym = fast_sym[peek]
        else:
            sym = -1
            for l in range(_HUF_DECBITS + 1, 59):
                if l <= alen:
                    code = acc >> (alen - l)
                else:
                    code = acc << (l - alen)
                sym = slow.get((l, code), -1)
                if sym >= 0:
                    break
            if sym < 0:
                raise IOError("EXR/PIZ: invalid Huffman stream")
        if used + l > end_bit or l > alen:
            raise IOError("EXR/PIZ: Huffman data exhausted")
        alen -= l
        acc &= (1 << alen) - 1
        used += l
        if sym == rlc:
            while alen < 8 and bytei < nbytes:
                acc = (acc << 8) | data[bytei]
                bytei += 1
                alen += 8
            if used + 8 > end_bit or alen < 8:
                raise IOError("EXR/PIZ: Huffman data exhausted")
            run = (acc >> (alen - 8)) & 0xFF
            alen -= 8
            acc &= (1 << alen) - 1
            used += 8
            if not out or len(out) + run > n_out:
                raise IOError("EXR/PIZ: bad RLE run")
            out.extend([out[-1]] * run)
        else:
            push(sym)
    bits.pos = used
    return np.asarray(out, np.uint16)


def _wdec(l, h, w14):
    if w14:
        ls = l.astype(np.int16).astype(np.int64)
        hs = h.astype(np.int16).astype(np.int64)
        a = (ls + (hs & 1) + (hs >> 1)).astype(np.int16)
        b = (a.astype(np.int64) - hs).astype(np.int16)
        return a.astype(np.uint16), b.astype(np.uint16)
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(plane: np.ndarray, maxv: int) -> np.ndarray:
    """In-place inverse 2D wavelet (ImfWav wav2Decode semantics):
    pair offset p, block step p2 = 2p, coarse-to-fine."""
    ny, nx = plane.shape
    w14 = maxv < (1 << 14)
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            i00, i10 = _wdec(plane[yy, xx], plane[yy + p, xx], w14)
            i01, i11 = _wdec(plane[yy, xx + p], plane[yy + p, xx + p], w14)
            a, b = _wdec(i00, i01, w14)
            c_, d_ = _wdec(i10, i11, w14)
            plane[yy, xx] = a
            plane[yy, xx + p] = b
            plane[yy + p, xx] = c_
            plane[yy + p, xx + p] = d_
        if (nx & p) and ys.size:
            # leftover column (vertical-only pairs) at the first block
            # start past the 2D region
            xr = xs[-1] + p2 if xs.size else 0
            a, b = _wdec(plane[ys, xr], plane[ys + p, xr], w14)
            plane[ys, xr] = a
            plane[ys + p, xr] = b
        if (ny & p) and xs.size:
            # leftover row (horizontal-only pairs)
            yr = ys[-1] + p2 if ys.size else 0
            a, b = _wdec(plane[yr, xs], plane[yr, xs + p], w14)
            plane[yr, xs] = a
            plane[yr, xs + p] = b
        p2 = p
        p >>= 1
    return plane


def _piz_decode(raw: bytes, chans, w: int, ny: int) -> bytes:
    """Decode one PIZ chunk -> channel-interleaved scanline bytes."""
    for _, pt in chans:
        if pt != _HALF:
            raise IOError("EXR/PIZ: only HALF channels supported")
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", raw, pos)
    pos += 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(raw, np.uint8, nb, pos)
        pos += nb
    bits_set = np.unpackbits(bitmap, bitorder="little")
    lut = np.nonzero(bits_set)[0].astype(np.uint16)
    if lut.size == 0 or lut[0] != 0:
        lut = np.concatenate([[0], lut]).astype(np.uint16)
    (length,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    huf = raw[pos : pos + length]
    im, iM, _tbl, nbits, _room = struct.unpack_from("<5i", huf, 0)
    bits = _Bits(huf[20:])
    lengths = _huf_unpack_lengths(bits, im, iM)
    codes = _huf_canonical_codes(lengths)
    # data starts byte-aligned after the packed table
    bits.pos = (bits.pos + 7) & ~7
    end_bit = bits.pos + nbits
    n_out = len(chans) * w * ny
    out = _huf_decode(bits, end_bit, lengths, codes, iM, n_out)
    res = np.empty((ny, len(chans), w), np.uint16)
    o = 0
    # The wavelet ran over LUT-COMPACTED values on encode, so its 14-bit
    # fast path is selected by the compact-domain max (lut size), not
    # the raw half-bits max (reverseLutFromBitmap semantics).
    maxv = lut.size - 1
    for ci in range(len(chans)):
        plane = out[o : o + w * ny].reshape(ny, w).copy()
        o += w * ny
        _wav2_decode(plane, maxv)
        res[:, ci, :] = lut[np.minimum(plane, lut.size - 1)]
    return res.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR -> float32 (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    version = struct.unpack("<i", data[4:8])[0]
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR not supported")
    off = 8
    attrs = {}
    while data[off] != 0:
        e = data.index(b"\0", off)
        name = data[off:e].decode()
        off = e + 1
        e = data.index(b"\0", off)
        off = e + 1
        size = struct.unpack("<i", data[off:off + 4])[0]
        off += 4
        attrs[name] = data[off:off + size]
        off += size
    off += 1  # header terminator

    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][0]
    decreasing = attrs.get("lineOrder", b"\0")[0] == 1

    chans = []  # (name, ptype) in FILE (alphabetical) order
    cl = attrs["channels"]
    o = 0
    while cl[o] != 0:
        e = cl.index(b"\0", o)
        cname = cl[o:e].decode()
        o = e + 1
        ptype = struct.unpack("<i", cl[o:o + 4])[0]
        o += 16
        chans.append((cname, ptype))
    dtypes = {_HALF: np.dtype("<f2"), _FLOAT: np.dtype("<f4"),
              _UINT: np.dtype("<u4")}
    if comp in (0,):
        lines_per_chunk = 1
    elif comp == 2:  # ZIPS
        lines_per_chunk = 1
    elif comp == 3:  # ZIP
        lines_per_chunk = 16
    elif comp == 4:  # PIZ
        lines_per_chunk = 32
    else:
        raise IOError(
            f"{path}: compression {comp} not supported by the pure-Python "
            f"reader (NONE/ZIPS/ZIP/PIZ only)")

    n_chunks = -(-h // lines_per_chunk)
    offsets = struct.unpack(f"<{n_chunks}q", data[off:off + 8 * n_chunks])

    out = {name: np.empty((h, w), np.float32) for name, _ in chans}
    bytes_per_line = sum(dtypes[pt].itemsize for _, pt in chans) * w
    for pos in offsets:
        y, nb = struct.unpack("<ii", data[pos:pos + 8])
        raw = data[pos + 8 : pos + 8 + nb]
        ny = min(lines_per_chunk, y1 - y + 1)
        expect = bytes_per_line * ny
        if comp in (2, 3) and len(raw) != expect:
            # a chunk equal to its uncompressed size is stored raw
            # (OpenEXR keeps whichever is smaller)
            raw = zlib.decompress(raw)
            if len(raw) != expect:
                raise IOError(f"{path}: bad chunk size")
            raw = _zip_undo(raw)
        elif comp == 4:
            raw = _piz_decode(raw, chans, w, ny)
        for li in range(ny):
            row = y - y0 + li
            o = li * bytes_per_line
            for cname, ptype in chans:
                dt = dtypes[ptype]
                n = w * dt.itemsize
                vals = np.frombuffer(raw[o:o + n], dt).astype(np.float32)
                o += n
                out[cname][row] = vals
    _ = decreasing  # y in each chunk header is absolute: order-agnostic

    names = [c for c, _ in chans]
    if set(names) >= {"R", "G", "B"}:
        sel = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        sel = sorted(names)
    return np.stack([out[c] for c in sel], axis=-1)
