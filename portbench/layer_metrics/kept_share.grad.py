"""Share (%) of the graphed render's backwards served from the forward
graph's kept autograd residuals, out of all its backwards (kept, and
rendered again by any cause), from the port's graphs.BACKWARDS since
import; None from a port without that counter."""


def read(ctx):
    if ctx.kind != "grad":
        return None
    from redner_tpu_torch import graphs

    counts = getattr(graphs, "BACKWARDS", None)
    if not counts:
        return None
    total = sum(counts.values())
    return 100.0 * counts["kept"] / total if total else None
