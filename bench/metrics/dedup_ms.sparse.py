"""The sparse step's dedup (the stable sort and the B5 segment sum):
device ms a step of the operations launched inside the program's span
``obs.dedup`` (``kernels/ops.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.span_device_s("obs.dedup")
    return None if secs is None else 1e3 * secs / tr.steps
