"""Seconds of the graph cache's latest captures (forward and backward),
from the port's graphs.LAST_CAPTURE."""


def read(ctx):
    caps = [c["seconds"] for c in ctx.after.last_capture.values() if c]
    return sum(caps) if caps else None
