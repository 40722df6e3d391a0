"""The whole LM step: device ms a step of the operations launched
outside every program span (``obs.*``); None where the trace has no
program span."""
from harness.spans import unspanned_s


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = unspanned_s(tr)
    return None if secs is None else 1e3 * secs / tr.steps
