"""Device ms per gradient step of the scatter-adds that PyTorch runs for
the backward of gathers: index_put_ with accumulation after `x[idx]`
(indexing_backward_kernel) and index_add_ after `index_select`
(indexFuncLargeIndex / indexFuncSmallIndex), by the kernel names of the
first profiles."""

NAMES = ("indexing_backward_kernel", "indexFuncLargeIndex",
         "indexFuncSmallIndex")


def read(ctx):
    if ctx.kind != "grad" or ctx.profile is None:
        return None
    s = sum(b - a for nm, a, b in ctx.profile
            if any(n in nm for n in NAMES))
    return s * 1e3 / ctx.profiled
