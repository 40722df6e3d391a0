"""The sparse step's addressing (both sketches' buckets and the first
moment's signs): device ms a step of the operations launched inside the
program's span ``obs.hash`` (``kernels/ops.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.span_device_s("obs.hash")
    return None if secs is None else 1e3 * secs / tr.steps
