"""Whole sparse-rows step: the bytes it needs (``arith.sparse_step_bytes``
of the traced batches, averaged) over the unprofiled window's step time
and the HBM peak, in percent: a byte-bound step's share of the chip."""
from harness import arith


def read(ctx):
    if ctx["unit"] != "rows":
        return None
    c = ctx["counts"]
    need = [arith.sparse_step_bytes(b["k"], b["k_u"], c["d"], b["rows_m"],
                                    b["rows_v"]) for b in c["batches"]]
    return 100.0 * sum(need) / len(need) / ctx["step_s"] \
        / arith.HBM_BYTES_PER_S
