"""The two ray-query kernels' share of their roofline over one frame, in
%: the summed work bound of every closest-hit and any-hit launch of an
eager frame at the loop's inputs, over those kernels' summed device time
in the profile of the same frame."""


def read(ctx):
    if ctx.kind != "frame":
        return None
    got = [(b, t) for _, b, _, _, t in ctx.launches if t]
    if not got:
        return None
    return 100.0 * sum(b for b, _ in got) / sum(t for _, t in got)
