"""Phase-level profiling: named spans, trace dumps, latency histograms.

Counterpart of ``repro.obs.profiling``:

  * ``scope(name)`` - ``torch.profiler.record_function(name)``, a span
    that shows in ``torch.profiler`` traces beside the device kernels it
    launched, while a profiler (or a dispatch mode, such as
    ``launch.op_cost.OpCost``, which reads the spans) runs; otherwise a
    no-op context, so a span costs a check of the profiler's state;
  * ``kernel_work(name, flops, tensors)`` - reports a hand-written
    kernel's call to a dispatch mode that counts work (``OpCost``),
    which sees no such kernel otherwise; free when none runs;
  * ``PhaseTimer.phase(name)`` - host-side spans around a loop's phases
    (data / step / checkpoint).  Each span is a ``record_function`` (and
    an NVTX range when CUDA is up) AND accumulates wall time, drained into
    ``phase`` metrics records;
  * ``LatencyTracker`` - a bounded ring buffer of durations summarized
    into the schema's histogram shape (``metrics.HISTOGRAM_FIELDS``), in
    numpy, giving the reference's summaries to the bit;
  * ``maybe_trace(dir)`` - a ``torch.profiler`` trace of a block, written
    to ``dir`` as a Chrome trace (``*.pt.trace.json``).

Span names follow the reference's dotted ``obs.<phase>`` convention
(``obs.dedup``, ``obs.adapt``); ``data`` / ``step`` / ``checkpoint`` at
the loop level.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


_OFF = contextlib.nullcontext()


def scope(name: str):
    """A named profiler span around the code in its ``with`` block.  The
    profiler's state is read on every call, so a profiler started
    between two calls sees the second; with no profiler and no dispatch
    mode running it enters no ``record_function`` (a dispatcher op)."""
    if torch._C._autograd._profiler_enabled() \
            or torch._C._len_torch_dispatch_stack():
        return torch.profiler.record_function(name)
    return _OFF


def kernel_work(name: str, flops: float,
                tensors: Sequence[torch.Tensor]) -> None:
    """Reports one call of a hand-written kernel.  Such a kernel is no
    aten op, so a dispatch mode never sees it: the innermost mode with a
    ``record_kernel`` method (``launch.op_cost.OpCost``) is handed its
    ``name``, ``flops`` and the bytes of ``tensors`` (its operands and
    results).  With no dispatch mode running it does nothing."""
    if not torch._C._len_torch_dispatch_stack():
        return
    for mode in reversed(_get_current_dispatch_mode_stack()):
        record = getattr(mode, "record_kernel", None)
        if record is not None:
            record(name, float(flops), float(sum(t.nbytes for t in tensors)))
            return


@contextlib.contextmanager
def _trace_annotation(name: str) -> Iterator[None]:
    """A host span for the profiler and, when CUDA is up, an NVTX range
    for tools that read those."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class PhaseTimer:
    """Host-side named phase spans with wall-time accumulation.

        timer = PhaseTimer()
        with timer.phase("data"):
            batch = stream.batch(i)
        ...
        record = timer.drain()   # {"data": {count, total_ms, mean_ms}, ...}
    """

    def __init__(self):
        self._total_s: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with _trace_annotation(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._total_s[name] = self._total_s.get(name, 0.0) + dt
                self._count[name] = self._count.get(name, 0) + 1

    def drain(self) -> Dict[str, Dict[str, float]]:
        """Per-phase timing since the last drain; resets the counters."""
        out = {}
        for name, total in self._total_s.items():
            n = self._count[name]
            out[name] = {"count": n,
                         "total_ms": round(total * 1e3, 4),
                         "mean_ms": round(total * 1e3 / max(n, 1), 4)}
        self._total_s.clear()
        self._count.clear()
        return out


class LatencyTracker:
    """Bounded reservoir of durations -> p50/p90/p99 histogram summaries.

    ``record`` takes seconds; ``summary`` emits the schema's histogram
    shape (milliseconds).  The buffer keeps the most recent ``capacity``
    samples: serving runs care about the current latency regime, not the
    warmup tail."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._buf = np.zeros((self.capacity,), np.float64)
        self._n = 0          # total recorded (monotonic)

    def record(self, seconds: float) -> None:
        self._buf[self._n % self.capacity] = float(seconds)
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def _window(self) -> np.ndarray:
        return self._buf[: min(self._n, self.capacity)]

    def summary(self) -> Dict[str, float]:
        """Histogram summary over the retained window (ms)."""
        w = self._window()
        if w.size == 0:
            return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p90_ms": 0.0,
                    "p99_ms": 0.0, "max_ms": 0.0}
        ms = w * 1e3
        return {
            "count": int(self._n),
            "mean_ms": round(float(ms.mean()), 4),
            "p50_ms": round(float(np.percentile(ms, 50)), 4),
            "p90_ms": round(float(np.percentile(ms, 90)), 4),
            "p99_ms": round(float(np.percentile(ms, 99)), 4),
            "max_ms": round(float(ms.max()), 4),
        }

    def per_second(self) -> float:
        """Mean throughput implied by the retained window (events/s)."""
        w = self._window()
        tot = float(w.sum())
        return w.size / tot if tot > 0 else 0.0


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to
    ``profile_dir/<host>-<pid>-<ns>.pt.trace.json`` (host spans, and the
    device's kernels when CUDA is up); a no-op when ``profile_dir`` is
    falsy."""
    if not profile_dir:
        yield
        return
    out = pathlib.Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    name = f"{os.uname().nodename}-{os.getpid()}-{time.time_ns()}"
    prof.export_chrome_trace(str(out / f"{name}.pt.trace.json"))
