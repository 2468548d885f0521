"""Image IO with torch tensors (port of redner_torch/image.py; reference
pyredner/image.py)."""

from __future__ import annotations

import torch

import redner_tpu_torch as rtt
from redner_tpu_torch.frontend._tensor import _as_tensor


def imread(filename: str, gamma: float = 2.2) -> torch.Tensor:
    """Linear-radiance (H, W, C) image on the default device."""
    return _as_tensor(rtt.imread(filename, gamma=gamma))


def imwrite(img, filename: str, gamma: float = 2.2,
            normalize: bool = False):
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    rtt.imwrite(img, filename, gamma=gamma, normalize=normalize)
