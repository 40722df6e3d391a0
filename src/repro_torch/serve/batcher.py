"""Cross-request coalescing for online-adaptation serving.

Counterpart of ``repro.serve.batcher``.  Serving-time personalization
sees many small adapt requests, each touching a handful of embedding
rows, while the sketch step's cost is per launch, not per row.  The
``Batcher`` accumulates requests into a fixed ``batch_ids``-slot buffer
and flushes when it fills or the oldest member has waited
``max_delay_s`` (size-or-deadline batching).

Numerical contract (the reference's):

  * ``coalesce`` concatenates the member requests' (ids, rows) along the
    id axis and pads to ``batch_ids`` with the batch's FIRST id and zero
    gradient rows.  Any other filler id would be decayed by the EMA's
    ``(1-b2)(0^2 - v_hat)`` at a zero-gradient row; the first id merges
    through the dedup segment sum as ``+0.0``, an exact no-op.
  * The adapt step's dedup pre-pass keeps original positions within a
    segment and the padding last, so one step over the coalesced batch
    equals one step over the raw concatenation, bit for bit.

``coalesce`` builds the batch in pinned host memory and copies it to the
server's device with ``non_blocking=True``; the batch carries an event
after the copy (``CoalescedBatch.copied``) so a server can keep the copy
out of its timed service time.

``dedup_coalesce`` exposes the collision-free view (unique ids + summed
rows).  ``dedup_rows`` marks fill slots with ``fill_id=-1``, which JAX
wraps to the last table row but which is a device assert as a CUDA
index: they are remapped onto the first live id, with zero rows, before
anything gathers with them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import dedup as dedup_lib


@dataclasses.dataclass(frozen=True)
class AdaptRequest:
    """One user's online-adaptation request: ``ids`` (k,) embedding-row
    ids, duplicates allowed, and one gradient row per id."""

    user: int
    ids: np.ndarray          # (k,) int - embedding-row ids
    grad_rows: np.ndarray    # (k, d) float - one gradient row per id
    t_arrival: float = 0.0   # seconds on the trace clock

    @property
    def n_ids(self) -> int:
        return int(np.asarray(self.ids).shape[0])


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    batch_ids: int = 256      # fixed id-slot capacity of a coalesced batch
    max_delay_s: float = 5e-3  # oldest member waits at most this long


class CoalescedBatch:
    """A formed batch: fixed-shape (ids, rows) on the device plus its
    member requests.  ``copied``: a CUDA event after the batch's copy to
    the card (None on the CPU)."""

    __slots__ = ("ids", "rows", "requests", "n_live", "t_oldest", "copied")

    def __init__(self, ids, rows, requests: List[AdaptRequest],
                 n_live: int, t_oldest: float, copied=None):
        self.ids = ids            # (batch_ids,) int32
        self.rows = rows          # (batch_ids, d) float32
        self.requests = requests
        self.n_live = n_live      # id slots before padding
        self.t_oldest = t_oldest  # earliest member arrival
        self.copied = copied

    def __len__(self) -> int:
        return len(self.requests)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(a)
    if device.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def coalesce(requests: Sequence[AdaptRequest], batch_ids: int,
             device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate member requests and pad to the fixed batch shape.

    Returns ``(ids, rows)`` on ``device``, ``ids.shape == (batch_ids,)``
    int32, rows f32; padding slots repeat the first id with zero rows."""
    if not requests:
        raise ValueError("coalesce of an empty request list")
    ids = np.concatenate([np.asarray(r.ids, np.int32).reshape(-1)
                          for r in requests])
    rows = np.concatenate([np.asarray(r.grad_rows, np.float32)
                           for r in requests])
    k = ids.shape[0]
    if k > batch_ids:
        raise ValueError(f"coalesced batch has {k} id slots > "
                         f"batch_ids={batch_ids}")
    if k < batch_ids:
        pad = batch_ids - k
        ids = np.concatenate([ids, np.full((pad,), ids[0], np.int32)])
        rows = np.concatenate(
            [rows, np.zeros((pad, rows.shape[1]), rows.dtype)])
    device = torch.device(device)
    return _to_device(ids, device), _to_device(rows, device)


def dedup_coalesce(ids, rows) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Collision-free view of a coalesced batch, fixed shape, on the
    batch's device with no host sync.  Returns ``(unique_ids,
    summed_rows, n_unique)``: fill slots hold the first live id and zero
    rows."""
    db = dedup_lib.dedup_rows(ids.to(torch.int32), rows)
    live = db.mask > 0
    safe_ids = torch.where(live, db.unique_ids, db.unique_ids[0])
    safe_rows = torch.where(live[:, None], db.rows,
                            torch.zeros((), dtype=db.rows.dtype,
                                        device=db.rows.device))
    return safe_ids, safe_rows, db.n_unique


class Batcher:
    """Size-or-deadline request accumulator, single-threaded: the serving
    loop owns it (admission concurrency lives in ``serve.server``).

        b = Batcher(BatcherConfig(batch_ids=64, max_delay_s=0.002))
        if b.fits(req):
            b.add(req)
        batch = b.poll(now)        # CoalescedBatch when full/expired
        ...
        batch = b.flush()          # drain whatever is pending

    Batches are made on ``device``."""

    def __init__(self, config: BatcherConfig, device="cuda"):
        if config.batch_ids < 1:
            raise ValueError("batch_ids must be >= 1")
        self.config = config
        self.device = torch.device(device)
        self._pending: List[AdaptRequest] = []
        self._pending_ids = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending_ids(self) -> int:
        return self._pending_ids

    def fits(self, req: AdaptRequest) -> bool:
        return self._pending_ids + req.n_ids <= self.config.batch_ids

    def add(self, req: AdaptRequest) -> None:
        if req.n_ids > self.config.batch_ids:
            raise ValueError(
                f"request with {req.n_ids} ids can never fit a "
                f"batch_ids={self.config.batch_ids} batch")
        if not self.fits(req):
            raise ValueError("request does not fit the forming batch — "
                             "poll()/flush() first")
        self._pending.append(req)
        self._pending_ids += req.n_ids

    def deadline(self) -> Optional[float]:
        """Trace time at which the forming batch must flush (None when
        empty)."""
        if not self._pending:
            return None
        return self._pending[0].t_arrival + self.config.max_delay_s

    def ready(self, now: float) -> bool:
        """Full (no ``batch_ids``-slot request could still join) or the
        oldest member's deadline has passed."""
        if not self._pending:
            return False
        if self._pending_ids >= self.config.batch_ids:
            return True
        return now >= self.deadline()

    def poll(self, now: float) -> Optional[CoalescedBatch]:
        return self.flush() if self.ready(now) else None

    def flush(self) -> Optional[CoalescedBatch]:
        if not self._pending:
            return None
        reqs, n_live = self._pending, self._pending_ids
        self._pending, self._pending_ids = [], 0
        ids, rows = coalesce(reqs, self.config.batch_ids, self.device)
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        return CoalescedBatch(ids, rows, reqs, n_live,
                              t_oldest=reqs[0].t_arrival, copied=copied)
