"""Named spans for the profiler.

Counterpart of ``scope`` in ``repro.obs.profiling``: ``scope(name)`` is
``torch.profiler.record_function(name)``, a span that shows in
``torch.profiler`` traces beside the device kernels it launched, and
costs a few microseconds of host time when no profiler runs.  Span names
follow the reference's dotted ``obs.<phase>`` convention
(``obs.dedup``).  ``PhaseTimer``, ``LatencyTracker`` and the trace dumps
wait for ROADMAP A11.
"""
from __future__ import annotations

import torch


def scope(name: str):
    """A named profiler span around the code in its ``with`` block."""
    return torch.profiler.record_function(name)
