"""The port's own records of a traced stretch: its host spans, the device
phases its CUDA graphs time at every replay, and the ray-query work its
replays count (redner_tpu_torch.timing, ops/intersect_cuda.WORK), for the
per-layer readers that split a step or a frame by phase.

`context(ctx)` builds them once per run, after every reader that was
there before has read: a second loop made by the run's own
`ctx.make_loop` (the run's cell, configuration and seed, the port's keys
already captured, so its set-up replays), then `program_stretch`.  A
port without tracing (no `timing.set_tracing`) gives None, and so does a
run without a card.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import traceback

import torch

from portbench import trace as tr
from portbench import yardstick as ys

GATHER_BWD = ("indexing_backward_kernel", "indexFuncLargeIndex",
              "indexFuncSmallIndex")


def program_stretch(rtt, loop, n, spans, dev):
    """Tracing on: two calls (the traced key's eager run and its capture),
    n calls whose records and work summarise() reads, and n more under
    trace.profile_stretch for the busy time and the gaps (the profiler
    stretches a replay's kernels apart and its graph launches on the
    host, so the phases are read without it); tracing off again.  None
    when the port has no tracing or the profiler saw no device
    activity."""
    timing = getattr(rtt, "timing", None)
    if timing is None or not hasattr(timing, "set_tracing"):
        return None
    from redner_tpu_torch import graphs
    from redner_tpu_torch.ops import intersect_cuda as ic

    c0 = _cache_counts(graphs)
    timing.set_tracing(True)
    try:
        for _ in range(2):
            loop.step(loop.next_k)
            loop.next_k += 1
        torch.cuda.synchronize(dev)
        timing.records(clear=True)
        w0 = ic.work_counts()
        for _ in range(n):
            loop.step(loop.next_k)
            loop.next_k += 1
        recs = timing.records(clear=True)
        w1 = ic.work_counts()
        prof = tr.profile_stretch(loop, n, spans, dev)
        profiled = timing.records(clear=True)
    finally:
        timing.set_tracing(False)
    if prof is None:
        return None
    work = {k: ((w1[k][0] - w0[k][0]) / n, (w1[k][1] - w0[k][1]) / n)
            for k in w1}
    out = summarise(recs, work, n, prof, profiled)
    c1 = _cache_counts(graphs)
    out["cache_counts"] = {k: (v - c0[k], v) for k, v in c1.items()}
    return out


def _cache_counts(graphs):
    """The graph cache's RELEASED and EMPTY_CACHE counters."""
    return {"released": graphs.RELEASED, "empty_cache": graphs.EMPTY_CACHE}


def summarise(recs, work, n, prof, profiled):
    """Per call: from the unprofiled calls' records, device ms by phase
    name (`device_ms`, and by graph and name in `graph_ms`), host ms by
    span name and the graph cache's host ms (its outermost `cache.*`
    spans); the ray-query pairs and lanes; from the profiled calls, the
    device's busy ms (the profile's operations, the spans' own
    annotations left out), the whole-body phases' share of it, the
    gather backward's ms, and the idle gaps named by name_gaps with the
    profiled calls' spans."""
    kern, h0, wall, log = prof
    names = {r.name for r in profiled}
    kern = [k for k in kern if k[0] not in names]
    busy, gaps = ys.busy_and_gaps(kern, h0, h0 + wall)
    device_ms, graph_ms, host_ms = {}, {}, {}
    by_id = {r.id: r for r in recs}
    cache_s = 0.0
    for r in recs:
        if r.device is not None:
            device_ms[r.name] = device_ms.get(r.name, 0.0) + r.device
            g = (r.attrs or {}).get("graph")
            if g is not None:
                key = f"{g}:{r.name}"
                graph_ms[key] = graph_ms.get(key, 0.0) + r.device
        if r.seconds is not None:
            host_ms[r.name] = host_ms.get(r.name, 0.0) + r.seconds
            parent = by_id.get(r.parent)
            if r.name.startswith("cache.") and not (
                    parent is not None and parent.name.startswith("cache.")):
                cache_s += r.seconds
    per = 1e3 / n
    device_ms = {k: v * per for k, v in device_ms.items()}
    body = sum(device_ms.get(k, 0.0) for k in ("fwd", "bwd"))
    busy_ms = busy * per
    return {
        "calls": n,
        "device_ms": device_ms,
        "graph_ms": {k: v * per for k, v in graph_ms.items()},
        "host_ms": {k: v * per for k, v in host_ms.items()},
        "cache_host_ms": cache_s * per,
        "pairs": sum(p for p, _ in work.values()),
        "work": work,
        "busy_ms": busy_ms,
        "body_share": body / busy_ms if busy_ms else None,
        "gather_bwd_ms": sum(b - a for nm, a, b in kern
                             if any(g in nm for g in GATHER_BWD)) * per,
        "gaps": name_gaps(gaps, profiled, log),
    }


def name_gaps(gaps, recs, harness, top=10):
    """The longest idle gaps [(name, seconds)], each named by the innermost
    (shortest) host span of the program that covers most of it (more than
    half), else by the harness span that overlaps it most, else
    "harness"."""
    spans = [(r.name, r.start, r.end) for r in recs if r.seconds is not None]
    out = []
    for a, b in gaps:
        inside = [(s1 - s0, nm) for nm, s0, s1 in spans
                  if min(b, s1) - max(a, s0) > 0.5 * (b - a)]
        if inside:
            out.append((min(inside)[1], b - a))
            continue
        best, best_ov = "harness", 0.0
        for nm, s0, s1 in harness:
            ov = min(b, s1) - max(a, s0)
            if ov > best_ov:
                best, best_ov = nm, ov
        out.append((best, b - a))
    out.sort(key=lambda x: -x[1])
    return [[nm, s] for nm, s in out[:top]]


def traced_run(ctx):
    """program_stretch, over ctx.profiled calls on ctx.device, on a loop
    that the run's own ctx.make_loop(spans) builds (the run's cell,
    configuration and seed); its set-up notes are kept off standard
    error."""
    import redner_tpu_torch as rtt

    from portbench import loops

    if not hasattr(getattr(rtt, "timing", None), "set_tracing"):
        return None
    n, dev, make_loop = ctx.profiled, ctx.device, ctx.make_loop
    spans = loops.Spans(False)
    with contextlib.redirect_stderr(io.StringIO()):
        loop = make_loop(spans)
    return program_stretch(rtt, loop, n, spans, dev)


def context(ctx):
    """ctx.program: traced_run's summary, made at the first call (None
    without a card's profile, without tracing in the port, or when the
    stretch failed, whose error goes to standard error); ctx.first_run_s:
    the port's graphs.FIRST_RUN summed before that stretch (its own keys'
    first runs would add to it), None where the port has no FIRST_RUN."""
    if hasattr(ctx, "program"):
        return ctx.program
    ctx.program = ctx.first_run_s = None
    if getattr(ctx, "profile", None) is None:
        return None
    from redner_tpu_torch import graphs

    first = getattr(graphs, "FIRST_RUN", None)
    if first is not None:
        ctx.first_run_s = sum(first.values())
    try:
        ctx.program = traced_run(ctx)
    except Exception:  # noqa: BLE001 - the other readers still read
        print("[program] the traced stretch failed:\n"
              + traceback.format_exc(), file=sys.stderr)
        return None
    if ctx.program is not None:
        report(ctx.program)
    return ctx.program


def report(p):
    """The summary on standard error: the split of a call by phase, the
    whole-body phases against the busy time, the gathers' backward by
    site, the work, the graph cache's releases and emptyings (RELEASED,
    EMPTY_CACHE) and the named gaps."""
    def line(what):
        print(f"[program] {what}", file=sys.stderr)

    line("device ms a call by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(p["device_ms"].items(),
                                          key=lambda kv: -kv[1])))
    line("device ms a call by graph and phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(p["graph_ms"].items(),
                                          key=lambda kv: -kv[1])))
    line("host ms a call by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(p["host_ms"].items(),
                                          key=lambda kv: -kv[1])))
    share = p["body_share"]
    line(f"busy {p['busy_ms']:.3f} ms a call; fwd + bwd "
         f"{'n/a' if share is None else f'{100 * share:.2f}%'} of it")
    sb = p["device_ms"].get("bwd:shade.surface")
    if sb is not None and p["gather_bwd_ms"]:
        line(f"bwd:shade.surface {sb:.3f} ms beside the gathers' backward "
             f"{p['gather_bwd_ms']:.3f} ms a call: ratio "
             f"{sb / p['gather_bwd_ms']:.4f}")
    line(f"ray-query work a call (pairs, lanes): {p['work']}")
    cc = p.get("cache_counts")
    if cc is not None:
        line("graph cache over the stretch (since import): graphs "
             f"released {cc['released'][0]} ({cc['released'][1]}), cache "
             f"emptied {cc['empty_cache'][0]} ({cc['empty_cache'][1]})")
    line(f"program_gaps: {json.dumps(p['gaps'])}")
