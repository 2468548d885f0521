"""Active (tile, chunk) pairs the ray-query kernels ran per replayed
gradient step, both kernels: the port's device-side WORK sums over a
traced stretch (portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    p = program_trace.context(ctx)
    return None if p is None else p["pairs"]
