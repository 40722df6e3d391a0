"""The sparse step's update of the sketches and the rows (B1 on a card):
device ms a step of the operations launched inside the program's span
``obs.adam_rows`` (``kernels/ops.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.span_device_s("obs.adam_rows")
    return None if secs is None else 1e3 * secs / tr.steps
