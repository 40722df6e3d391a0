"""The model's backward, remat's recompute of the forward included:
device ms a step of the operations launched inside the program's span
``obs.backward`` (``train/steps.py``, inside ``obs.grad``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.backward")
    return None if secs is None else 1e3 * secs / tr.steps
