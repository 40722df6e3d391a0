"""The optimizer and its apply (``step_fn``): device ms a step of the
operations launched inside the benchmark's span ``bench.sparse_update``."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.span_device_s("bench.sparse_update")
    return None if secs is None else 1e3 * secs / tr.steps
