"""A few steps under ``torch.profiler``, reduced to what the per-layer
metrics read.

The profiler records the host's operators and spans (``record_function``:
the program's ``obs.*`` scopes and the benchmark's own ``bench.*``) and
every device operation (kernels, copies, fills).  Its Chrome trace is
written to a temporary directory (``TMPDIR``), read back and deleted.
Each device operation is tied to the host span that launched it through
its launch call's correlation id; one whose launch the trace lacks takes
the launch time of the operation before it on the stream.  The device's
busy time is the union of its operations' intervals.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def short(name: str, width: int = 96) -> str:
    """A device operation's name without its return type and arguments."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


class Trace:
    """The reduced trace of ``steps`` profiled steps."""

    def __init__(self, events: List[dict], steps: int, window_s: float):
        self.steps = steps
        self.window_s = window_s
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                      and e.get("ph") == "X"), key=lambda e: e["ts"])
        self.ops: List[Tuple[str, float, float, float]] = []  # name, ts, dur, launch
        last = float("-inf")
        for e in dev:
            t = launch.get(e.get("args", {}).get("correlation"), last)
            last = t
            self.ops.append((e["name"], float(e["ts"]), float(e["dur"]),
                             float(t)))
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("ph") == "X":
                self.spans.setdefault(e["name"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        self._host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]) for e in events
                            if e.get("cat") in HOST_CATS
                            and e.get("ph") == "X")
        self._host_ts = [h[0] for h in self._host]

    # -- the device ------------------------------------------------------
    def _union(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _n, ts, dur, _l in self.ops:
            end = ts + dur
            if out and ts <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], end))
            else:
                out.append((ts, end))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    @property
    def launches(self) -> int:
        return len(self.ops)

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose name ``match``es."""
        return sum(dur for name, _ts, dur, _l in self.ops
                   if match(name)) * 1e-6

    def span_device_s(self, span: str) -> Optional[float]:
        """Seconds of the device operations launched inside host span
        ``span``; None when the trace has no such span."""
        iv = self.spans.get(span)
        if not iv:
            return None
        iv = sorted(iv)
        starts = [a for a, _b in iv]
        total = 0.0
        for _n, _ts, dur, t in self.ops:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += dur
        return total * 1e-6

    # -- the breakdown ---------------------------------------------------
    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _ts, dur, _l in self.ops:
            key = short(name)
            by[key] = by.get(key, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._host_ts, t) - 1
        for j in range(i, max(-1, i - 4000), -1):
            a, b, name = self._host[j]
            if b > t:
                return name
        return "(host outside any operator)"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time between its operations, summed by the
        innermost host operator running when each gap began."""
        by: Dict[str, float] = {}
        u = self._union()
        for (_a, end), (start, _b) in zip(u, u[1:]):
            key = self._host_at(end)
            by[key] = by.get(key, 0.0) + (start - end) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def profile(step: Callable[[int], object], first: int, steps: int,
            sync: Callable[[], None], cuda: bool) -> Trace:
    """``steps`` calls ``step(first + j)`` under the profiler (after one
    profiled call that warms it up), ended by ``sync()``."""
    from torch.profiler import ProfilerActivity, profile as _profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _profile(activities=acts):
        step(first)
        sync()
    sync()
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        with _profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for j in range(1, steps + 1):
                step(first + j)
            sync()
            window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, steps, window_s)
