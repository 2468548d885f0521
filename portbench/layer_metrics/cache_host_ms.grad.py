"""Host ms per gradient step in the graph cache's outermost `cache.*`
spans (lookup, load, replay, copy; eager runs and captures where any), in
a traced stretch (portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    p = program_trace.context(ctx)
    return None if p is None else p["cache_host_ms"]
