"""Device operations per gradient step in the profiled steady stretch."""


def read(ctx):
    if ctx.kind != "grad" or ctx.profile is None:
        return None
    return len(ctx.profile) / ctx.profiled
