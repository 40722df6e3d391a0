"""The readers of the Mamba2 SSD's backward span and kernel counters:
``ssd_bwd_ms.lm`` on hand-written traces (the span ``obs.ssd_bwd``
nested inside ``obs.backward``, once a layer in each step, beside
``obs.ssd`` in the forward and remat's recompute), and
``ssd_kernel_share.lm`` on the program's ``ssd_chunked`` counters,
including a program that keeps none."""
from __future__ import annotations

import pytest

from harness_tiny import manifest
from harness.spans import unspanned_s
from harness.trace import Trace

STEPS = 2
PERIOD = 1000.0


def _trace(bwd_span=True):
    events, corr = [], 0

    def span(name, a, b):
        for j in range(STEPS):
            events.append({"cat": "user_annotation", "ph": "X",
                           "name": name, "ts": j * PERIOD + a,
                           "dur": b - a})

    def launch(t, dur):
        nonlocal corr
        for j in range(STEPS):
            corr += 1
            o = j * PERIOD
            events.append({"cat": "cuda_runtime", "ph": "X",
                           "name": "cudaLaunchKernel", "ts": o + t,
                           "dur": 1.0, "args": {"correlation": corr}})
            events.append({"cat": "kernel", "ph": "X", "name": f"op{t}",
                           "ts": o + t + 0.5, "dur": dur,
                           "args": {"correlation": corr}})

    span("obs.grad", 0.0, 400.0)
    span("obs.forward", 10.0, 150.0)
    span("obs.backward", 160.0, 390.0)
    span("obs.ssd", 30.0, 60.0)             # the forward
    span("obs.ssd", 200.0, 230.0)           # remat's recompute
    if bwd_span:
        span("obs.ssd_bwd", 300.0, 350.0)   # the kernels' backward
        span("obs.ssd_bwd", 360.0, 380.0)   # a second layer's
    launch(20.0, 10.0)                      # projections
    launch(40.0, 3.0)                       # the SSD's forward
    launch(210.0, 3.0)                      # its recompute
    launch(240.0, 50.0)                     # other backward
    launch(310.0, 11.0)                     # the SSD's backward
    launch(365.0, 13.0)                     # a second layer's
    launch(420.0, 5.0)                      # outside the grad
    return Trace(events, STEPS, STEPS * PERIOD * 1e-6)


def _read(metric, trace, unit):
    return manifest.reader(metric)({"trace": trace, "unit": unit})


def test_ssd_bwd_ms_reads_the_span_a_step():
    tr = _trace()
    assert _read("ssd_bwd_ms.lm", tr, "tokens") == pytest.approx(0.024)
    assert _read("ssd_ms.lm", tr, "tokens") == pytest.approx(0.006)
    assert _read("ssd_bwd_ms.lm", tr, "rows") is None
    assert _read("ssd_bwd_ms.lm", None, "tokens") is None


def test_the_backward_span_lies_inside_the_backward():
    tr = _trace()
    assert _read("ssd_bwd_ms.lm", tr, "tokens") <= _read(
        "backward_ms", tr, "tokens")
    # a nested program span leaves the unspanned time as it was
    assert unspanned_s(tr) == pytest.approx(unspanned_s(_trace(False)))


def test_a_program_without_the_span_reads_no_backward():
    assert _read("ssd_bwd_ms.lm", _trace(bwd_span=False), "tokens") is None


@pytest.mark.parametrize("calls,kernel,want", [
    (18, 18, 100.0), (18, 0, 0.0), (8, 6, 75.0), (0, 0, None)])
def test_ssd_kernel_share_reads_the_counters(monkeypatch, calls, kernel,
                                             want):
    from repro_torch.models import mamba
    monkeypatch.setattr(mamba.ssd_chunked, "calls", calls)
    monkeypatch.setattr(mamba.ssd_chunked, "kernel_calls", kernel)
    tr = _trace()
    got = _read("ssd_kernel_share.lm", tr, "tokens")
    assert got == (None if want is None else pytest.approx(want))
    assert _read("ssd_kernel_share.lm", tr, "rows") is None
    assert _read("ssd_kernel_share.lm", None, "tokens") is None


def test_a_program_without_the_counters_reads_no_share(monkeypatch):
    from repro_torch.models import mamba
    monkeypatch.delattr(mamba.ssd_chunked, "calls")
    monkeypatch.delattr(mamba.ssd_chunked, "kernel_calls")
    assert _read("ssd_kernel_share.lm", _trace(), "tokens") is None
