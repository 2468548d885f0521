"""Tensor conversion of the front end's inputs (no package-internal
imports beyond the device helpers).

Python lists and numpy arrays become tensors on the default device
(`set_device`; the CUDA card unless set_device("cpu")).  A tensor that is
given moves there with the differentiable `.to()`, which returns the tensor
itself when it is already there, so a leaf the user made stays the leaf the
render differentiates.
"""

from __future__ import annotations

import torch

from redner_tpu_torch.device import resolve_device


def _as_tensor(x, dtype=torch.float32):
    if x is None:
        return None
    dev = resolve_device(None)
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _as_int_tensor(x):
    return _as_tensor(x, torch.int32)
