"""Device ms per gradient step of `bwd:shade.surface`, every bounce: the
backward of the hits' surface points and materials, where the vertex,
corner and material gathers scatter-add their gradients, from the marks
of the port's phases in a traced stretch (portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    p = program_trace.context(ctx)
    return None if p is None else p["device_ms"].get("bwd:shade.surface")
