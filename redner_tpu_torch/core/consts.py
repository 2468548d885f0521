"""Constant tensors made once per (value, dtype, device) and kept.

A tensor built from Python numbers on a card (`torch.tensor(list,
device="cuda")`) is a synchronous copy from pageable host memory: a host
sync in an eager run, and an error inside a CUDA-graph capture.  `const`
makes each constant once, through pinned memory (an asynchronous copy),
and returns the kept tensor on every later call.  Callers never write to
it.  graphs.py runs every configuration eagerly before it captures it, so
a capture only meets constants that already exist.
"""

from __future__ import annotations

import torch

_KEPT = {}


def const(values, dtype, device, key=None):
    """The constant tensor of `values` (nested Python numbers, or a
    callable returning an array when `key` names it) on (dtype, device).
    Values are keyed by their repr, which tells -0.0 from 0.0."""
    device = torch.device(device)
    k = (repr(values) if key is None else key, dtype, device)
    t = _KEPT.get(k)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"redner_tpu_torch: constant {k[0]!r} first asked for "
                "during CUDA-graph capture (the warm-up run did not make it)")
        host = torch.as_tensor(values() if callable(values) else values,
                               dtype=dtype)
        if device.type == "cuda":
            t = host.pin_memory().to(device, non_blocking=True)
        else:
            t = host.to(device, copy=True)
        _KEPT[k] = t
    return t
