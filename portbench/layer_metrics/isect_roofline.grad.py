"""The two ray-query kernels' share of their roofline over one gradient
step, in %: the summed work bound of every closest-hit and any-hit launch
of an eager step at the loop's inputs, over those kernels' summed device
time in the profile of the same step."""


def read(ctx):
    if ctx.kind != "grad":
        return None
    got = [(b, t) for _, b, _, _, t in ctx.launches if t]
    if not got:
        return None
    return 100.0 * sum(b for b, _ in got) / sum(t for _, t in got)
