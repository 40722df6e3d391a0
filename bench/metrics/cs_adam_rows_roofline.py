"""The sparse optimizer's kernels (``('pair', 'adam_rows')`` on ``tiled``:
B1's ``tiled_read``, the run scatter ``run_scatter`` of B1 and of the
dedup sum, and ``csr_kernel``): the byte bounds of the step's B1 call
(``arith.b1_bytes``) and dedup sum (``arith.b5_bytes`` at depth 1, the
unique ids its touched rows) at the HBM peak, over those kernels'
device time in the trace, in percent."""
from harness import arith

KERNELS = ("tiled_read", "run_scatter", "csr_kernel")


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None:
        return None
    secs = tr.device_s(lambda n: any(k in n for k in KERNELS))
    if secs <= 0.0:
        return None
    c = ctx["counts"]
    need = sum(arith.b1_bytes(c["d"], b["k"], b["k_u"], b["rows_m"],
                              b["rows_v"], c["depth"])
               + arith.b5_bytes(b["k"], c["d"], b["k_u"], 1)
               for b in c["batches"])
    return 100.0 * need / arith.HBM_BYTES_PER_S / secs
