"""The traced run's readings: a device profile of a steady stretch of the
loop with the harness's host spans beside it, the ray-query launches of
one eager call with their work bounds, and the port's graph-cache
counters.  What they gather goes into a context that the per-layer
readers (layer_metrics/<name>.py) read.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import yardstick as ys

KERNELS = {"closest_hit": "closest_hit_kernel", "any_hit": "any_hit_kernel"}


def _device_events(prof):
    from torch.autograd import DeviceType

    return sorted(((e.name, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6) for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda x: x[1])


def profile_stretch(loop, n, spans, device):
    """n steps or frames under torch.profiler with device activity only
    (host op events of a 60k-kernel step cost the profiler tens of
    seconds), the harness's spans on.  A marker kernel launched right
    after a synchronise ties the device clock to the host's.  Returns
    (kernels [(name, start_s, end_s)] on the host clock, start_s,
    wall_s, spans) or None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    spans.on, spans.log = True, []
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        h0 = time.perf_counter()
        marker.add_(1.0)
        for _ in range(n):
            loop.step(loop.next_k)
            loop.next_k += 1
        torch.cuda.synchronize(device)
        h1 = time.perf_counter()
    spans.on = False
    kern = _device_events(prof)
    if not kern:
        return None
    offset = kern[0][1] - h0  # the marker starts as the host launches it
    kern = [(nm, a - offset, b - offset) for nm, a, b in kern[1:]]
    return kern, h0, h1 - h0, list(spans.log)


def summarise(kern, wall_s, span_log, h0):
    """busy_s, the top device ops and the longest idle gaps (named by the
    host span they fall in most) of a profiled stretch [h0, h0 + wall_s]."""
    busy, gaps = ys.busy_and_gaps(kern, h0, h0 + wall_s)
    by_name = {}
    for nm, a, b in kern:
        by_name[nm] = by_name.get(nm, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = []
    for a, b in gaps:
        best, best_ov = "harness", 0.0
        for nm, s0, s1 in span_log:
            ov = min(b, s1) - max(a, s0)
            if ov > best_ov:
                best, best_ov = nm, ov
        named.append((best, b - a))
    named.sort(key=lambda x: -x[1])
    return busy, [[n, s] for n, s in top], [[n, s] for n, s in named[:10]]


def eager_launches(call, device):
    """The ray-query launches of one eager call (graphs disabled), each
    with its work bound, and the device time of each kernel in a profile
    of the same call: [(kind, bound_s, bound_by, tests, kernel_s)], in
    launch order.  The launches' inputs are recorded by wrapping the
    port's two launchers from this side; a graph replay cannot be seen
    from Python."""
    from torch.profiler import ProfilerActivity, profile

    from redner_tpu_torch import graphs
    from redner_tpu_torch.ops import intersect_cuda as ic

    seen = []
    orig = {k: getattr(ic, k) for k in KERNELS}

    def wrap(kind):
        def launcher(lay, rb):
            seen.append((kind, lay, rb))
            return orig[kind](lay, rb)
        return launcher

    try:
        for k in KERNELS:
            setattr(ic, k, wrap(k))
        with graphs.disable(), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize(device)
    finally:
        for k, f in orig.items():
            setattr(ic, k, f)
    times = {k: [b - a for nm, a, b in _device_events(prof)
                 if kn in nm] for k, kn in KERNELS.items()}
    out, used = [], {k: 0 for k in KERNELS}
    for kind, lay, rb in seen:
        steps = None
        if kind == "any_hit":
            steps = ys.anyhit_settle_steps(lay.Tc, rb.R, rb.tmin, rb.tmax,
                                           rb.mask)
        bound_s, by, tests = ys.work_bound(
            lay.ntri, lay.Tp.numel(), rb.R, rb.tmin, rb.tmax, rb.live,
            rb.mask, int(rb.count), steps)
        i = used[kind]
        used[kind] += 1
        kt = times[kind][i] if i < len(times[kind]) else None
        out.append((kind, bound_s, by, tests, kt))
    return out


def graph_counters():
    """A snapshot of the port's graph-cache counters."""
    from redner_tpu_torch import graphs

    return SimpleNamespace(replays=dict(graphs.REPLAYS),
                           eager=dict(graphs.EAGER),
                           captures=dict(graphs.CAPTURES),
                           last_capture={k: (dict(v) if v else None) for k, v
                                         in graphs.LAST_CAPTURE.items()})
