"""Device ms per frame in the ray queries' `isect.*` phases (the
launcher's layout, mask and work list, the kernel and the epilogue), from
the port's own phase events in a traced stretch
(portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "frame":
        return None
    p = program_trace.context(ctx)
    if p is None:
        return None
    return sum(v for k, v in p["device_ms"].items()
               if k.startswith("isect."))
