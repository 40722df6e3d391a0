"""The held experts' grouped products: their forward FLOPs in the traced
steps (``expert_rows``, the program's counter of the assignments that
held experts computed, times ``arith_hybrid_moe.expert_flops_per_row``,
2·3·d·f a row) at the bf16 peak over the device time of the operations
launched inside the program's span ``obs.experts``
(``models/moe.py``: the three grouped products of the forward and of
remat's recompute, which the counter counts alike; their backward runs
outside every span and is not counted), in percent.  None where the
program keeps no counter or the trace has no such span."""
from harness import arith


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    rows = ctx["counts"].get("expert_rows")
    secs = tr.span_device_s("obs.experts")
    if not rows or not secs:
        return None
    flops = rows * ctx["counts"]["expert_flops_per_row"]
    return 100.0 * flops / arith.PEAK_BF16_FLOPS / secs
