"""Device selection for the port's entry points (port of
redner_tpu/device.py; reference pyredner/device.py).

Every entry point takes an explicit `device`.  Left as None it means the
default device: the one `set_device` chose, else the CUDA card.  A caller
that wants the CPU (the tests) passes device="cpu" or calls
set_device("cpu").  Asking for CUDA on a machine without it raises instead
of quietly running on the CPU.
"""

from __future__ import annotations

import torch

_device = None  # set_device's choice; None = the CUDA card


def set_device(device):
    """Set the default device of entry points called without one: a
    torch.device, a string ("cpu", "cuda", "cuda:1") or a CUDA card index.
    None restores the default, the CUDA card."""
    global _device
    if isinstance(device, int):
        device = torch.device("cuda", device)
    _device = None if device is None else torch.device(device)


def get_device() -> torch.device:
    """The default device (raises when it is CUDA and there is no card)."""
    return resolve_device(None)


def use_gpu() -> bool:
    """True when the default device is a CUDA card that is present
    (reference pyredner.get_use_gpu)."""
    dev = _device if _device is not None else torch.device("cuda")
    return dev.type == "cuda" and torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (None = the default)."""
    if device is None:
        dev = _device if _device is not None else torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redner_tpu_torch: CUDA was requested (device="
            f"{device!r}) but torch.cuda.is_available() is False; pass "
            "device='cpu' or call set_device('cpu') to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def set_numerics():
    """Exact f32 everywhere: TF32 would erase the ~1e-5 direction split of
    edge-sampling ray pairs (ROADMAP "Numerics rule")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
