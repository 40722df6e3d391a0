"""The optimizer (B3 on the tables, dense Adam elsewhere): device ms a
step of the operations launched inside the program's span ``obs.kernel``
(``train/steps.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.kernel")
    return None if secs is None else 1e3 * secs / tr.steps
