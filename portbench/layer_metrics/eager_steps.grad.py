"""Window steps that did not replay both of the render's graphs, from the
deltas of the port's graphs.REPLAYS over the window."""


def read(ctx):
    if ctx.kind != "grad":
        return None
    replayed = min(ctx.after.replays[k] - ctx.before.replays[k]
                   for k in ("forward", "backward"))
    return max(ctx.window_count - replayed, 0)
