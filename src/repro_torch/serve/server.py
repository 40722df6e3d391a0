"""Online-adaptation serving loop: bounded admission, size-or-deadline
batching, double-buffered state, shed-on-overload.

Counterpart of ``repro.serve.server``:

    requests ──submit──► admission queue (bounded; overflow is SHED)
                              │ arrival order
                              ▼
                        forming batch (serve.batcher — size-or-deadline)
                              │ dispatch when full/expired AND device free
                              ▼
                    coalesced adapt step (timed_adapt → LatencyTracker)
                              │ stage → publish
                              ▼
                  DoubleBufferedStore (lock-free read path)

Clock model, the reference's: virtual-time discrete-event replay with
MEASURED service times.  Arrivals advance a virtual clock (the trace's
``t_arrival`` timeline), while each dispatched batch's service time is
the real wall time of its adapt step (``warmup`` runs the step once
first, on a scratch copy).  The arrival process is exact and
deterministic; only the service-time samples come from the machine under
test.  The batch's copy to the card is not in the service time (the
server waits for it before the clock starts, as the reference's
``coalesce`` runs before it); the copy of the published generation that
``begin_adapt`` makes is, since it is part of producing a generation.

Dispatch discipline: at most one batch is in flight; a formed batch
dispatches at ``max(trigger, busy_until)`` where ``trigger`` is the
batcher's size-or-deadline firing time.  Requests arriving while the
device is busy queue up; when the queue holds ``queue_cap`` they are
shed at admission (a ``Completion`` in the ``shed`` state, at once).

Each ``submit`` returns a ``Completion`` future, resolved with the
publishing generation's version and the request's virtual completion
time (queueing + service), or shed.  ``metrics_record()`` emits the
schema's ``serve`` kind through ``obs.metrics``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, List, Optional

import torch

from repro_torch.obs.profiling import LatencyTracker
from repro_torch.serve.batcher import AdaptRequest, Batcher, BatcherConfig
from repro_torch.serve.buffer import DoubleBufferedStore, clone_tree
from repro_torch.serve.steps import timed_adapt


class RequestShed(RuntimeError):
    """Raised by ``Completion.result()`` when admission shed the request."""


class Completion:
    """Per-request future.  States: pending → done | shed."""

    __slots__ = ("request", "t_submit", "t_done", "version", "state")

    def __init__(self, request: AdaptRequest, t_submit: float):
        self.request = request
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self.version: Optional[int] = None
        self.state = "pending"

    def done(self) -> bool:
        return self.state != "pending"

    @property
    def shed(self) -> bool:
        return self.state == "shed"

    def result(self) -> int:
        """The table generation that includes this request's update."""
        if self.state == "shed":
            raise RequestShed(f"request from user {self.request.user} shed "
                              f"at t={self.t_submit:.6f}s (queue full)")
        if self.state != "done":
            raise RuntimeError("request still pending — drain() the server")
        return self.version

    @property
    def latency_s(self) -> Optional[float]:
        """Virtual submit→publish latency (queueing + batching + service);
        None while pending or when shed."""
        if self.state != "done":
            return None
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    batch_ids: int = 256       # id-slot capacity per coalesced batch
    max_delay_s: float = 5e-3  # batcher deadline
    queue_cap: int = 64        # admission backlog (requests) before shedding
    slo_p99_ms: float = 50.0   # target for report-time SLO warnings
    latency_capacity: int = 4096


class AdaptServer:
    """Single-writer serving loop over one embedding table."""

    def __init__(self, table, opt_state, adapt_fn,
                 config: Optional[ServerConfig] = None):
        self.config = config or ServerConfig()
        self.store = DoubleBufferedStore(table, opt_state)
        self._raw_adapt = adapt_fn
        self._adapt, self.adapt_latency = timed_adapt(
            adapt_fn, capacity=self.config.latency_capacity)
        self.request_latency = LatencyTracker(self.config.latency_capacity)
        self._batcher = Batcher(BatcherConfig(
            batch_ids=self.config.batch_ids,
            max_delay_s=self.config.max_delay_s), device=table.device)
        self._forming: List[Completion] = []
        self._t_full: Optional[float] = None  # when the forming batch filled
        self._queue: Deque[Completion] = deque()
        self.busy_until = 0.0
        self.n_submitted = 0
        self.n_shed = 0
        self.n_done = 0
        self.n_batches = 0

    # -- read path ---------------------------------------------------------
    def read_rows(self, ids):
        """Lock-free lookup against the published generation."""
        return self.store.read_rows(ids)

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> None:
        """Run the adapt step once outside the measurement (the first
        call builds kernels and caches hash parameters on the card).  The
        step writes its inputs in place, so it runs on a scratch copy of
        the published generation, which is then dropped."""
        snap = self.store.read()
        table, opt_state = clone_tree(snap.table), clone_tree(snap.opt_state)
        ids = torch.zeros((self.config.batch_ids,), dtype=torch.int32,
                          device=table.device)
        rows = torch.zeros((self.config.batch_ids, table.shape[1]),
                           dtype=table.dtype, device=table.device)
        self._raw_adapt(table, opt_state, ids, rows)
        if table.device.type == "cuda":
            torch.cuda.synchronize(table.device)

    def submit(self, req: AdaptRequest,
               now: Optional[float] = None) -> Completion:
        """Admit (or shed) one request at virtual time ``now`` (defaults
        to the request's ``t_arrival``)."""
        now = req.t_arrival if now is None else now
        self._pump(now)
        self.n_submitted += 1
        comp = Completion(req, now)
        if len(self._queue) >= self.config.queue_cap:
            comp.state = "shed"
            self.n_shed += 1
            return comp
        self._queue.append(comp)
        self._pump(now)
        return comp

    def drain(self, now: float = math.inf) -> None:
        """Flush and execute everything still queued/forming."""
        self._pump(now)

    # -- event loop --------------------------------------------------------
    def _fill_forming(self) -> None:
        while self._queue and self._batcher.fits(self._queue[0].request):
            comp = self._queue.popleft()
            self._batcher.add(comp.request)
            self._forming.append(comp)
            if self._batcher.pending_ids >= self.config.batch_ids:
                self._t_full = comp.t_submit
        # a queued head that does NOT fit also closes the batch: nothing
        # more can join once that request arrived
        if (self._t_full is None and self._queue and self._forming
                and not self._batcher.fits(self._queue[0].request)):
            self._t_full = self._queue[0].t_submit

    def _pump(self, now: float) -> None:
        """Run every dispatch whose (virtual) time is <= now.  Called on
        each submit BEFORE the new request enters the queue, so the
        forming batch only ever contains requests that had arrived by the
        dispatch instant."""
        while True:
            self._fill_forming()
            if not self._forming:
                return
            trigger = self._batcher.deadline()
            if self._t_full is not None:
                trigger = min(trigger, self._t_full)
            t_dispatch = max(self.busy_until, trigger)
            if t_dispatch > now:
                return
            self._execute(t_dispatch)

    def _execute(self, t_dispatch: float) -> None:
        batch = self._batcher.flush()
        comps, self._forming, self._t_full = self._forming, [], None
        if batch.copied is not None:
            batch.copied.synchronize()     # the batch's copy, untimed
        table, opt_state = self.store.begin_adapt()
        t0 = time.perf_counter()
        new_table, new_state = self._adapt(table, opt_state,
                                           batch.ids, batch.rows)
        service_s = time.perf_counter() - t0   # timed_adapt blocked already
        self.store.stage(new_table, new_state)
        snap = self.store.publish(block=False)
        self.busy_until = t_dispatch + service_s
        self.n_batches += 1
        for comp in comps:
            comp.t_done = self.busy_until
            comp.version = snap.version
            comp.state = "done"
            self.request_latency.record(comp.t_done - comp.t_submit)
        self.n_done += len(comps)

    # -- telemetry ---------------------------------------------------------
    @property
    def shed_rate(self) -> float:
        return self.n_shed / max(self.n_submitted, 1)

    def metrics_record(self, **extra) -> dict:
        """A schema-valid ``serve`` record: real adapt-latency histogram,
        virtual request-latency histogram (queueing included), adapt
        throughput, shed rate and the configured SLO target (so the
        report can warn without out-of-band context)."""
        return {
            "adapt_ms": self.adapt_latency.summary(),
            "request_ms": self.request_latency.summary(),
            "reads_per_s": round(self.adapt_latency.per_second(), 4),
            "n_requests": self.n_submitted,
            "n_batches": self.n_batches,
            "n_shed": self.n_shed,
            "shed_rate": round(self.shed_rate, 6),
            "queue_depth": len(self._queue) + len(self._forming),
            "slo_p99_ms": self.config.slo_p99_ms,
            **extra,
        }

    def emit(self, writer, **extra) -> dict:
        """Write the ``serve`` record through an ``obs.MetricsWriter``."""
        return writer.write("serve", **self.metrics_record(**extra))


def replay(server: AdaptServer, trace,
           warmup: bool = True) -> List[Completion]:
    """Feed a ``serve.traffic`` trace through the server on its own
    virtual timeline; returns one ``Completion`` per request (arrival
    order).  The trace must be sorted by ``t_arrival``."""
    if warmup:
        server.warmup()
    comps = [server.submit(req) for req in trace]
    server.drain()
    return comps
