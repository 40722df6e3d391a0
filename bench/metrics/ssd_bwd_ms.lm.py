"""The Mamba2 SSD's backward: device ms a step of the operations
launched inside the program's span ``obs.ssd_bwd`` (``models/mamba.py``:
the chunked-scan kernels' backward, nested in ``obs.backward``; the
forward and remat's recompute are ``ssd_ms.lm``'s); None where the
trace has no such span."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "tokens" or tr is None:
        return None
    secs = tr.span_device_s("obs.ssd_bwd")
    return None if secs is None else 1e3 * secs / tr.steps
