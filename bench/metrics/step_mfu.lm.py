"""Whole LM step: model FLOPs a step (``harness.arith``: 6·N a token, N
without the embedding table, plus the sequence mixer's products) over
the unprofiled window's step time and the bf16 peak, in percent."""
from harness import arith


def read(ctx):
    if ctx["unit"] != "tokens":
        return None
    return 100.0 * ctx["counts"]["flops_per_step"] / ctx["step_s"] \
        / arith.PEAK_BF16_FLOPS
