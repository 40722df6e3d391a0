"""The gradient clip and the clipped gradient's norm, each a pass over
every leaf: device ms a step of the operations launched inside the
program's span ``obs.clip`` (``train/steps.py``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.clip")
    return None if secs is None else 1e3 * secs / tr.steps
