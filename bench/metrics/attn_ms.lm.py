"""Attention: device ms a step of the operations launched inside the
program's span ``obs.attn`` (``models/attention.py``: the forward of
either path, remat's recompute of it and the backward, nested inside
``obs.forward`` and ``obs.backward``); None where the trace has no such
span."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.attn")
    return None if secs is None else 1e3 * secs / tr.steps
