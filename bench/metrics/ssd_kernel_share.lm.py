"""The Mamba2 SSD's kernel share: of the program's ``ssd_chunked`` calls
in this run's process, the percentage that took the chunked-scan kernels
(``models/mamba.py``: ``ssd_chunked.kernel_calls`` over
``ssd_chunked.calls``).  Every step of a run is the same step, so the
share over the run is the share over its traced steps.  None off the
card (a run without a device trace, where no kernel can run), and where
the program keeps no such counters or made no call."""


def read(ctx):
    if ctx["unit"] != "tokens" or ctx["trace"] is None:
        return None
    from repro_torch.models import mamba
    fn = mamba.ssd_chunked
    calls = getattr(fn, "calls", None)
    kernel = getattr(fn, "kernel_calls", None)
    if not calls or kernel is None:
        return None
    return 100.0 * kernel / calls
