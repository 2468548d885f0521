"""Native mesh processing through ctypes (port of redner_tpu/meshops.py):
vertex welding (reference rebuild_topology, src/rebuild_topology.cpp),
automatic UV atlases (reference automatic_uv_map / xatlas) and a fast OBJ
geometry scan.

The C++ source is the repository's native/meshops.cpp, compiled on first use
with `g++ -O2 -shared -fPIC` into redner_tpu_torch/_build/ (keyed by a hash
of the source), the directory the CUDA kernels are built in.  A failed build
raises.  Everything here is host-side numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
SRC = _PKG_DIR.parent / "native" / "meshops.cpp"
BUILD_DIR = _PKG_DIR / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib_handle = None


def build() -> Path:
    """Compile native/meshops.cpp into BUILD_DIR once per source version;
    returns the library's path."""
    src = SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libmeshops_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"redner_tpu_torch: g++ failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        f, i32, i64 = (ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_int32), ctypes.c_int64)
        lib.weld_vertices.restype = ctypes.c_int64
        lib.weld_vertices.argtypes = [f, i64, f, ctypes.c_float, i32, f, f]
        lib.atlas_uv.restype = ctypes.c_int64
        lib.atlas_uv.argtypes = [f, i64, i32, i64, ctypes.c_float, f, i32]
        lib.obj_count.restype = ctypes.c_int32
        lib.obj_count.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.obj_read.restype = ctypes.c_int32
        lib.obj_read.argtypes = [ctypes.c_char_p, f, i32]
        _lib_handle = lib
    return _lib_handle


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(x):
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _weld(v, u, eps):
    """(welded count, remap (V,), representative positions, uvs) for
    positions v (V, 3) and optional uvs u (V, 2)."""
    if v.ndim != 2 or v.shape[1] != 3 or (
            u is not None and u.shape != (v.shape[0], 2)):
        raise ValueError("weld: want vertices (V, 3) and uvs (V, 2)")
    remap = np.empty((v.shape[0],), np.int32)
    out_v = np.empty_like(v)
    out_u = (np.empty_like(u) if u is not None
             else np.empty((0, 2), np.float32))
    count = _lib().weld_vertices(
        _fptr(v), v.shape[0], _fptr(u) if u is not None else None,
        ctypes.c_float(eps), _iptr(remap), _fptr(out_v), _fptr(out_u))
    return count, remap, out_v, out_u


def weld_mesh(vertices, indices, uvs=None, eps: float = 1e-6):
    """Weld vertices closer than eps (and with equal uvs, when given) so
    edge extraction sees shared faces.  Returns (vertices', indices',
    uvs' or None)."""
    v = _f32(vertices)
    u = None if uvs is None else _f32(uvs)
    count, remap, out_v, out_u = _weld(v, u, eps)
    new_u = out_u[:count].copy() if u is not None else None
    return out_v[:count].copy(), remap[np.asarray(indices, np.int32)], new_u


def weld_ids(vertices, eps: float) -> np.ndarray:
    """(V,) int32 canonical original vertex id per vertex under an eps
    position weld: a keying map for edge extraction; geometry, uvs and
    normals are untouched.  The first original vertex of each welded group
    represents it."""
    v = _f32(vertices)
    n = v.shape[0]
    count, remap, _, _ = _weld(v, None, eps)
    rep = np.full((count,), n, np.int64)
    np.minimum.at(rep, remap, np.arange(n))
    return rep[remap].astype(np.int32)


def compute_uvs(vertices, indices, normal_cos_threshold: float = 0.75):
    """Automatic UV atlas (pyredner.compute_uvs, pyredner/shape.py:279-326):
    normal-clustered charts, planar projection, shelf packing.  Returns
    (uvs (3F, 2), uv_indices (F, 3))."""
    v = _f32(vertices).reshape(-1, 3)
    f = np.ascontiguousarray(np.asarray(indices, np.int32)).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError("compute_uvs: a face index is out of range")
    F = f.shape[0]
    out_uvs = np.empty((3 * F, 2), np.float32)
    out_idx = np.empty((F, 3), np.int32)
    _lib().atlas_uv(_fptr(v), v.shape[0], _iptr(f), F,
                    ctypes.c_float(normal_cos_threshold), _fptr(out_uvs),
                    _iptr(out_idx))
    return out_uvs, out_idx


def load_obj_fast(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Native two-pass OBJ geometry scan: (positions (V, 3) float32,
    fan-triangulated faces (F, 3) int32).  Attributes and materials come
    from io.obj.load_obj."""
    lib = _lib()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    if lib.obj_count(path.encode(), ctypes.byref(nv), ctypes.byref(nf)) != 0:
        raise IOError(f"cannot open {path}")
    v = np.empty((nv.value, 3), np.float32)
    f = np.empty((nf.value, 3), np.int32)
    if lib.obj_read(path.encode(), _fptr(v), _iptr(f)) != 0:
        raise IOError(f"cannot read {path}")
    return v, f
