"""The LM step's apply of the updates to the params: device ms a step of
the operations launched inside the program's span ``obs.apply``
(``train/steps.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.apply")
    return None if secs is None else 1e3 * secs / tr.steps
