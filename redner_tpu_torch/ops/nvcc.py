"""Builds a CUDA C++ source of csrc/ for sm_90a with nvcc into a shared
library with a plain C interface, once per version of the source and
flags (the library's name carries their hash), into BUILD_DIR.  The
kernels' wrappers load the library with ctypes at their first launch."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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


def build_library(src_path: Path, stem: str,
                  verbose: bool = False) -> Tuple[Path, str]:
    """Compile src_path into BUILD_DIR/lib<stem>_<hash>.so unless it is
    there.  Returns (library path, compiler output); verbose adds
    `-Xptxas -v` (registers, shared memory and spills per kernel) and
    forces a rebuild so the report is fresh."""
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"redner_tpu_torch: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
