"""Device ms per gradient step of the backward graph's `autograd` phase
(torch.autograd.grad through the re-render), from the port's own phase
events in a traced stretch (portbench/program_trace.py); its `bwd:<phase>`
parts and `autograd.other` add up to it."""

from portbench import program_trace


def read(ctx):
    if ctx.kind != "grad":
        return None
    p = program_trace.context(ctx)
    return None if p is None else p["device_ms"].get("autograd")
