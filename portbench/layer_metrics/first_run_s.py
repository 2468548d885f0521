"""Seconds of the graph cache's first eager runs in this run's set-up
(each key's first forward and backward, synchronised), from the port's
graphs.FIRST_RUN, read before the traced stretch adds its own keys'
(portbench/program_trace.py)."""

from portbench import program_trace


def read(ctx):
    program_trace.context(ctx)
    return getattr(ctx, "first_run_s", None)
