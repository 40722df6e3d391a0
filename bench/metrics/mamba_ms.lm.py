"""The Mamba2 mixers: device ms a step of the operations launched inside
the program's span ``obs.mamba`` (``models/mamba.py``: each mixer's
projections, convs, SSD, gated norm and output projection in the forward
and in remat's recompute; autograd runs their backward outside every
span, so it is not here); None where the trace has no such span."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.mamba")
    return None if secs is None else 1e3 * secs / tr.steps
