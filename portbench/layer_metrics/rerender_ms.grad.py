"""Device ms per gradient step of the backward graph's `rerender` phase
(the forward rendered again under autograd), from the port's own phase
events in a traced stretch (portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    p = program_trace.context(ctx)
    return None if p is None else p["device_ms"].get("rerender")
