"""Device selection for the port's entry points.

Every entry point takes an explicit `device`.  Left as None it means the
CUDA card; a caller that wants the CPU (the tests) passes device="cpu".
Asking for CUDA on a machine without it raises instead of quietly running
on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (None = the CUDA card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redner_tpu_torch: CUDA was requested (device="
            f"{device!r}) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def set_numerics():
    """Exact f32 everywhere: TF32 would erase the ~1e-5 direction split of
    edge-sampling ray pairs (ROADMAP "Numerics rule")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
