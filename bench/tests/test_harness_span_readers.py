"""The readers of the program's spans inside both training steps and of
the kernel library's build-or-load counter, on hand-written traces: two
steps of Chrome events with nested spans, launches tied to their device
operations by correlation id, a device operation whose launch the trace
lacks, and operations launched outside every program span."""
from __future__ import annotations

import ctypes

import pytest

from harness_tiny import manifest
from harness.trace import Trace

STEPS = 2
PERIOD = 1000.0


class _Events:
    """Chrome events of ``STEPS`` steps, each a copy of one step's."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def span(self, name, a, b):
        for j in range(STEPS):
            o = j * PERIOD
            self.events.append({"cat": "user_annotation", "ph": "X",
                                "name": name, "ts": o + a, "dur": b - a})

    def launch(self, t, dur, kind="kernel", tied=True):
        """A device operation of ``dur`` µs launched at ``t``; untied, its
        launch is not in the trace."""
        for j in range(STEPS):
            o = j * PERIOD
            self.corr += 1
            args = {"correlation": self.corr} if tied else {}
            if tied:
                self.events.append({"cat": "cuda_runtime", "ph": "X",
                                    "name": "cudaLaunchKernel", "ts": o + t,
                                    "dur": 1.0, "args": dict(args)})
            self.events.append({"cat": kind, "ph": "X", "name": f"op{t}",
                                "ts": o + t + 0.5, "dur": dur,
                                "args": args})

    def trace(self):
        return Trace(self.events, STEPS, STEPS * PERIOD * 1e-6)


def _sparse_trace(spans=True):
    ev = _Events()
    ev.launch(-50.0, 13.0)                  # the rows and loss, no span
    ev.span("bench.sparse_update", 0.0, 500.0)
    if spans:
        ev.span("obs.dedup", 10.0, 100.0)
        ev.span("obs.hash", 110.0, 200.0)
        ev.span("obs.adam_rows", 210.0, 300.0)
        ev.span("obs.apply", 310.0, 400.0)
    ev.launch(20.0, 30.0)                   # dedup
    ev.launch(120.0, 5.0)                   # hash
    ev.launch(130.0, 7.0)
    ev.launch(220.0, 40.0)                  # B1
    ev.launch(221.0, 3.0, "gpu_memset", tied=False)
    ev.launch(320.0, 20.0)                  # apply
    ev.launch(450.0, 11.0)                  # the lr scale, in no span
    return ev.trace()


def _lm_trace(spans=True):
    ev = _Events()
    ev.span("obs.grad", 0.0, 400.0)
    if spans:
        ev.span("obs.forward", 10.0, 150.0)
        ev.span("obs.backward", 160.0, 390.0)
        ev.span("obs.clip", 410.0, 450.0)
        ev.span("obs.apply", 510.0, 550.0)
    ev.span("obs.kernel", 460.0, 500.0)
    ev.launch(20.0, 100.0)                  # forward
    ev.launch(200.0, 200.0)                 # backward, remat included
    ev.launch(300.0, 50.0)
    ev.launch(420.0, 8.0)                   # clip
    ev.launch(470.0, 30.0)                  # B3 and dense Adam
    ev.launch(520.0, 6.0)                   # apply
    ev.launch(560.0, 2.0)                   # in no span
    return ev.trace()


def _read(metric, trace, unit):
    return manifest.reader(metric)({"trace": trace, "unit": unit})


SPARSE = {"dedup_ms.sparse": 0.030, "hash_ms.sparse": 0.012,
          "adam_rows_ms.sparse": 0.043, "apply_ms.sparse": 0.020,
          "unspanned_ms.sparse": 0.011}
LM = {"forward_ms": 0.100, "backward_ms": 0.250, "clip_ms": 0.008,
      "apply_ms.lm": 0.006, "unspanned_ms.lm": 0.002}


@pytest.mark.parametrize("metric", sorted(SPARSE))
def test_sparse_readers(metric):
    tr = _sparse_trace()
    assert _read(metric, tr, "rows") == pytest.approx(SPARSE[metric])
    assert _read(metric, tr, "tokens") is None
    assert _read(metric, None, "rows") is None


@pytest.mark.parametrize("metric", sorted(LM))
def test_lm_readers(metric):
    tr = _lm_trace()
    assert _read(metric, tr, "tokens") == pytest.approx(LM[metric])
    assert _read(metric, tr, "rows") is None
    assert _read(metric, None, "tokens") is None


def test_the_sparse_stages_sum_to_the_step():
    tr = _sparse_trace()
    whole = _read("sparse_update_ms", tr, "rows")
    assert whole == pytest.approx(0.116)
    assert sum(_read(m, tr, "rows") for m in SPARSE) == pytest.approx(whole)


def test_the_lm_stages_sum_to_the_step():
    tr = _lm_trace()
    assert _read("forward_ms", tr, "tokens") + _read(
        "backward_ms", tr, "tokens") == pytest.approx(
        _read("grad_ms", tr, "tokens"))
    parts = sum(_read(m, tr, "tokens") for m in
                ("grad_ms", "clip_ms", "optimizer_ms", "apply_ms.lm",
                 "unspanned_ms.lm"))
    assert parts == pytest.approx(tr.device_s(lambda _n: True) * 1e3
                                  / STEPS)


def test_a_program_without_the_spans_reads_nothing_new():
    sparse, lm = _sparse_trace(spans=False), _lm_trace(spans=False)
    for m in SPARSE:
        assert _read(m, sparse, "rows") is None
    for m in ("forward_ms", "backward_ms", "clip_ms", "apply_ms.lm"):
        assert _read(m, lm, "tokens") is None
    # the parent's LM step has obs.grad and obs.kernel: what lies outside
    # them is read, clip and apply included
    assert _read("unspanned_ms.lm", lm, "tokens") == pytest.approx(0.016)


def test_kernel_load_reads_the_program_counter(monkeypatch):
    from repro_torch.kernels import build
    read = manifest.reader("kernel_load_s")
    monkeypatch.setattr(build, "_LOAD", {})
    build.library.cache_clear()
    try:
        assert read({}) is None
        monkeypatch.setattr(build, "build",
                            lambda: ("libcs_kernels.so", 12.5, "log"))
        monkeypatch.setattr(ctypes, "CDLL", lambda path: _Lib())
        build.library()
        got = read({})
        assert got == build.load_stats()["seconds"] and got >= 0.0
        monkeypatch.delattr(build, "load_stats")
        assert read({}) is None
    finally:
        build.library.cache_clear()


class _Lib:
    def __getattr__(self, name):
        return lambda *a: 0
