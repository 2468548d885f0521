"""Device operations per frame in the profiled steady stretch."""


def read(ctx):
    if ctx.kind != "frame" or ctx.profile is None:
        return None
    return len(ctx.profile) / ctx.profiled
