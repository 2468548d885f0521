"""Image IO (port of redner_tpu/io/image.py; reference pyredner/image.py).

EXR goes through the package's own numpy + zlib codec (io/exr.py), so the
format every HDR asset and output here uses needs no extra module.  PNG,
JPEG and the other LDR formats go through PIL (with sRGB conversion) and
Radiance .hdr through OpenCV; each is imported only when such a file is
asked for, and a missing module raises with the format named.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

from redner_tpu_torch.io.exr import read_exr, write_exr


def srgb_to_linear(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1.0 / 2.4) - 0.055)


def _module(name: str, ext: str):
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"redner_tpu_torch: reading or writing {ext} files needs the "
            f"'{name}' module, which is not installed (EXR needs nothing)"
        ) from e


def imread(filename: str, gamma: float = 2.2) -> np.ndarray:
    """Read an image -> float32 linear-radiance array (H, W, C).  EXR and
    HDR are read as they are; LDR formats are converted from sRGB
    (gamma=2.2) or raised to `gamma` (pyredner/image.py:44-71)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".exr":
        return read_exr(filename)
    if ext == ".hdr":
        cv2 = _module("cv2", ext)
        img = cv2.imread(filename, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"cannot read {filename}")
        if img.ndim == 3 and img.shape[2] >= 3:
            img = img[..., [2, 1, 0] + list(range(3, img.shape[2]))]  # BGR
        return np.asarray(img, np.float32)
    image = _module("PIL.Image", ext)
    img = np.asarray(image.open(filename), np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if gamma == 2.2:
        return srgb_to_linear(img)
    return img ** gamma


def imwrite(img, filename: str, gamma: float = 2.2, normalize: bool = False):
    """Write a linear-radiance image (numpy or a tensor on any device); LDR
    formats get sRGB encoding (pyredner/image.py:7-42)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-12)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".exr":
        write_exr(filename, img)
        return
    if ext == ".hdr":
        cv2 = _module("cv2", ext)
        out = img[..., [2, 1, 0]] if img.ndim == 3 and img.shape[2] >= 3 \
            else img
        cv2.imwrite(filename, out.astype(np.float32))
        return
    image = _module("PIL.Image", ext)
    ldr = linear_to_srgb(img) if gamma == 2.2 else \
        np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    u8 = (ldr * 255.0 + 0.5).astype(np.uint8)
    if u8.ndim == 3 and u8.shape[2] == 1:
        u8 = u8[..., 0]
    image.fromarray(u8).save(filename)
