"""The model's forward (the loss): device ms a step of the operations
launched inside the program's span ``obs.forward`` (``train/steps.py``,
inside ``obs.grad``)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.forward")
    return None if secs is None else 1e3 * secs / tr.steps
