"""The readers of attention's span and kernel counters: ``attn_ms.lm``
on hand-written traces (the span ``obs.attn`` nested inside
``obs.forward`` and ``obs.backward``, twice in each step), and
``attn_kernel_share.lm`` on the program's ``flash_attention`` counters,
including a program that keeps none."""
from __future__ import annotations

import pytest

from harness_tiny import manifest
from harness.trace import Trace

STEPS = 2
PERIOD = 1000.0


def _trace(attn=True):
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
    if attn:
        span("obs.attn", 30.0, 60.0)        # the forward
        span("obs.attn", 200.0, 230.0)      # remat's recompute
        span("obs.attn", 300.0, 350.0)      # the backward
    launch(20.0, 10.0)                      # projections
    launch(40.0, 7.0)                       # attention forward
    launch(210.0, 7.0)                      # recompute
    launch(240.0, 50.0)                     # other backward
    launch(310.0, 19.0)                     # attention backward
    launch(420.0, 5.0)                      # outside the grad
    return Trace(events, STEPS, STEPS * PERIOD * 1e-6)


def _read(metric, trace, unit):
    return manifest.reader(metric)({"trace": trace, "unit": unit})


def test_attn_ms_reads_the_span_a_step():
    tr = _trace()
    assert _read("attn_ms.lm", tr, "tokens") == pytest.approx(0.033)
    assert _read("attn_ms.lm", tr, "rows") is None
    assert _read("attn_ms.lm", None, "tokens") is None


def test_attn_ms_lies_inside_the_forward_and_backward():
    tr = _trace()
    inner = _read("attn_ms.lm", tr, "tokens")
    assert inner <= _read("grad_ms", tr, "tokens")
    assert _read("forward_ms", tr, "tokens") + _read(
        "backward_ms", tr, "tokens") == pytest.approx(
        _read("grad_ms", tr, "tokens"))


def test_a_program_without_the_span_reads_no_attention():
    assert _read("attn_ms.lm", _trace(attn=False), "tokens") is None


@pytest.mark.parametrize("calls,kernel,want", [
    (72, 72, 100.0), (72, 0, 0.0), (8, 6, 75.0), (0, 0, None)])
def test_attn_kernel_share_reads_the_counters(monkeypatch, calls, kernel,
                                              want):
    from repro_torch.models import attention
    monkeypatch.setattr(attention.flash_attention, "calls", calls)
    monkeypatch.setattr(attention.flash_attention, "kernel_calls", kernel)
    tr = _trace()
    got = _read("attn_kernel_share.lm", tr, "tokens")
    assert got == (None if want is None else pytest.approx(want))
    assert _read("attn_kernel_share.lm", tr, "rows") is None
    assert _read("attn_kernel_share.lm", None, "tokens") is None


def test_a_program_without_the_counters_reads_no_share(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.delattr(attention.flash_attention, "calls")
    monkeypatch.delattr(attention.flash_attention, "kernel_calls")
    assert _read("attn_kernel_share.lm", _trace(), "tokens") is None
