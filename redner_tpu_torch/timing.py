"""Timing and profiling helpers (port of redner_tpu/timing.py; reference
pyredner.set_print_timing, pyredner/render_pytorch.py:31-44).

`set_print_timing(True)` makes `timed(label)` blocks print their wall time;
`profile_trace(dir)` records a torch.profiler trace of its block and
writes it to `dir` as a Chrome trace (chrome://tracing, Perfetto)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from redner_tpu_torch.device import use_gpu

_print_timing = False


def set_print_timing(v: bool):
    global _print_timing
    _print_timing = bool(v)


def get_print_timing() -> bool:
    return _print_timing


@contextlib.contextmanager
def timed(label: str):
    """Print the block's wall time when set_print_timing(True).  On the
    card both clock reads follow a torch.cuda.synchronize(), so the time
    is the work's and not the launches'."""
    if not _print_timing:
        yield
        return
    sync = torch.cuda.synchronize if use_gpu() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    yield
    sync()
    print(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    when there is one), written to log_dir as a Chrome trace JSON file.
    Yields the profiler, whose key_averages() tabulate the same events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
