"""Device ms per frame in the `shade.*` phases (surface points and
materials, NEE and BSDF shading, every bounce), from the port's own
phase events in a traced stretch (portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "frame":
        return None
    p = program_trace.context(ctx)
    if p is None:
        return None
    return sum(v for k, v in p["device_ms"].items()
               if k.startswith("shade."))
