"""The Mamba2 SSD: device ms a step of the operations launched inside the
program's span ``obs.ssd`` (``models/mamba.py``, nested in
``obs.mamba``: the chunked scan in the forward and in remat's
recompute; its backward runs outside every span); None where the
trace has no such span."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.ssd")
    return None if secs is None else 1e3 * secs / tr.steps
