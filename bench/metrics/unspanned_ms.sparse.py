"""The whole sparse step: device ms a step of the operations launched
inside the benchmark's span ``bench.sparse_update`` and outside every
program span (``obs.*``); None where the step has no program span."""
from harness.spans import unspanned_s


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = unspanned_s(tr, within="bench.sparse_update")
    return None if secs is None else 1e3 * secs / tr.steps
