"""Mitsuba `.serialized` mesh loader (a copy of redner_tpu/io/serialized.py,
which is plain numpy; the port keeps its own).

Pure-Python re-implementation of the reference's miniz-based loader
(src/load_serialized.cpp, src/miniz.c): the format is a sequence of
zlib-compressed mesh blobs with an offset dictionary at the end of file.
Python's zlib replaces the vendored miniz.

Format (Mitsuba 0.5):
  header: uint16 magic 0x041C, uint16 version (3 or 4)
  per mesh (zlib stream): uint32 flags, [version>=4: null-terminated name],
  uint64 vertex_count, uint64 tri_count, then vertex data arrays
  (positions, optional normals/texcoords/colors) in single or double
  precision by flag, then uint32/uint64 triangle indices.
  file tail: uint32 mesh_count preceded by mesh_count offsets
  (uint32 for version 3, uint64 for version 4).
"""

from __future__ import annotations

import struct as _struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

MTS_FILEFORMAT_HEADER = 0x041C

# flags (Mitsuba TriMesh serialization flags)
HAS_NORMALS = 0x0001
HAS_TEXCOORDS = 0x0002
HAS_COLORS = 0x0008
USE_FACE_NORMALS = 0x0010
SINGLE_PRECISION = 0x1000
DOUBLE_PRECISION = 0x2000


class SerializedMesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (F, 3) int32
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    colors: Optional[np.ndarray]


def load_serialized(filename: str, shape_index: int = 0) -> SerializedMesh:
    with open(filename, "rb") as f:
        data = f.read()
    magic, version = _struct.unpack_from("<HH", data, 0)
    if magic != MTS_FILEFORMAT_HEADER:
        raise IOError(f"{filename}: bad serialized header {magic:#x}")
    (count,) = _struct.unpack_from("<I", data, len(data) - 4)
    if shape_index >= count:
        raise IndexError(f"shape_index {shape_index} >= mesh count {count}")
    if version >= 4:
        table = len(data) - 4 - 8 * count
        offsets = _struct.unpack_from(f"<{count}Q", data, table)
    else:
        table = len(data) - 4 - 4 * count
        offsets = _struct.unpack_from(f"<{count}I", data, table)
    start = offsets[shape_index] + 4  # skip per-mesh header repeat
    end = offsets[shape_index + 1] if shape_index + 1 < count else table
    blob = zlib.decompress(data[start:end])

    pos = 0
    (flags,) = _struct.unpack_from("<I", blob, pos)
    pos += 4
    if version >= 4:
        # null-terminated mesh name
        zero = blob.index(b"\x00", pos)
        pos = zero + 1
    vcount, tcount = _struct.unpack_from("<QQ", blob, pos)
    pos += 16
    double = bool(flags & DOUBLE_PRECISION)
    fdtype = np.float64 if double else np.float32
    fsize = 8 if double else 4

    def read_arr(n, comps):
        nonlocal pos
        arr = np.frombuffer(blob, fdtype, n * comps, pos).reshape(n, comps)
        pos += n * comps * fsize
        return arr.astype(np.float32)

    vertices = read_arr(vcount, 3)
    normals = read_arr(vcount, 3) if flags & HAS_NORMALS else None
    uvs = read_arr(vcount, 2) if flags & HAS_TEXCOORDS else None
    colors = read_arr(vcount, 3) if flags & HAS_COLORS else None
    if flags & USE_FACE_NORMALS:
        normals = None
    remaining = len(blob) - pos
    if remaining >= tcount * 3 * 8 and vcount > 0xFFFFFFFF // 2:
        idx = np.frombuffer(blob, np.uint64, tcount * 3, pos)
    else:
        idx = np.frombuffer(blob, np.uint32, tcount * 3, pos)
    indices = idx.reshape(tcount, 3).astype(np.int32)
    return SerializedMesh(
        vertices=vertices, indices=indices, normals=normals, uvs=uvs,
        colors=colors,
    )
