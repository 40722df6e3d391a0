"""The sparse step's apply of the row updates to the table: device ms a
step of the operations launched inside the program's span ``obs.apply``
(``train/steps.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.span_device_s("obs.apply")
    return None if secs is None else 1e3 * secs / tr.steps
