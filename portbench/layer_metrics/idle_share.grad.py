"""The device's idle share of a gradient step, in %: 100 * (1 - busy / wall),
busy the device seconds a gradient step in the profiled stretch (the union of
its device operations, over the gradient steps profiled), wall the untraced
window's seconds a gradient step.  The profiler's host work stretches traced
gradient steps, so their own wall time would count the profiler as idle.  A device
busy throughout reads near 0, and noise can take that a little under."""


def read(ctx):
    if ctx.kind != "grad" or ctx.profile is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.profiled / ctx.step_s)
