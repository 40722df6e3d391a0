"""The expert layers: device ms a step of the operations launched inside
the program's span ``obs.moe`` (``models/moe.py``: the router, the
dispatch, the grouped products over the held experts, the combine and
the shared expert, in the forward and in remat's recompute; autograd
runs their backward outside every span); None where the trace
has no such span."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.moe")
    return None if secs is None else 1e3 * secs / tr.steps
