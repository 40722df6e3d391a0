"""B3 (``cs_ema_tiled``: its ``ema_read`` and ``ema_scatter`` launches)
on the LM step: its byte bound (``arith.b3_bytes`` of each call, the
tables' M and V each step) at the HBM peak over its device time in the
trace, in percent."""
from harness import arith

KERNELS = ("ema_read", "ema_scatter")


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.device_s(lambda n: any(k in n for k in KERNELS))
    if secs <= 0.0:
        return None
    per_step = sum(arith.b3_bytes(c["n"], c["d"], c["depth"], c["width"],
                                  c["signed"])
                   for c in ctx["counts"]["b3_calls"])
    return 100.0 * per_step * tr.steps / arith.HBM_BYTES_PER_S / secs
