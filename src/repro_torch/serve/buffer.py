"""Double-buffered (table, optimizer state) store: lock-free serve reads
against in-flight adapt steps.

Counterpart of ``repro.serve.buffer``, with one difference of design.
The reference relies on immutable arrays: a reader holding generation N
keeps it for as long as it likes.  The port's adapt steps write the
table and the sketch IN PLACE, so here the writer never touches a
published generation:

  * Readers call ``read()``, a single Python attribute load of a
    ``Snapshot`` (atomic under the GIL).  No lock; a published snapshot
    is never written again, so a reader holding generation N reads the
    same bits after any number of later publishes.
  * ``begin_adapt()`` hands the (single) writer a COPY of the published
    (table, opt_state): copy-on-write.  The copy is queued on the
    current stream, so it costs the card one read and one write of the
    generation (PERF.md) and the host nothing.
  * ``stage`` lands the writer's result (invisible to readers);
    ``publish(block=True)`` records a CUDA event after the staged writes
    and waits on it before swapping the reference.  The swap is one
    assignment: a reader sees generation N complete or N+1 complete,
    never a torn mix.

Readers gather on the same (default) stream as the writer, so the
caching allocator never reuses an old generation's memory before the
reads queued on it have run.
"""
from __future__ import annotations

import threading
from typing import Any, NamedTuple, Tuple

import torch


class Snapshot(NamedTuple):
    """One published generation; never written after its publish."""

    table: Any       # (n, d) tensor
    opt_state: Any   # optimizer-state tree (count-min sketch et al.)
    version: int     # generation counter, +1 per publish


def clone_tree(tree):
    """A deep copy of a tree of dicts, lists, tuples, NamedTuples
    (``QuantState``, ``Rank1Moment``, ``Snapshot``) and tensors (None and
    host scalars kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


class DoubleBufferedStore:
    """Published/shadow generations of a (table, opt_state) pair.

        store = DoubleBufferedStore(table, opt_state)
        snap = store.read()                    # lock-free, any thread
        t, s = store.begin_adapt()             # writer: a private copy
        store.stage(*adapt_fn(t, s, ids, rows))
        store.publish()                        # wait for it, then swap

    One writer at a time; ``_write_lock`` only guards against writer
    misuse and never touches the read path."""

    def __init__(self, table, opt_state):
        self._published = Snapshot(table, opt_state, 0)
        self._shadow: Tuple[Any, Any] | None = None
        self._write_lock = threading.Lock()

    # -- read path (lock-free) --------------------------------------------
    def read(self) -> Snapshot:
        """Current published generation: one attribute load, never
        blocks on an in-flight adapt."""
        return self._published

    def read_rows(self, ids) -> Tuple[Any, int]:
        """Serve-side lookup: gather rows from the published table.
        Returns ``(rows, version)``."""
        snap = self._published
        return snap.table[ids], snap.version

    @property
    def version(self) -> int:
        return self._published.version

    # -- write path (single writer) ---------------------------------------
    def begin_adapt(self) -> Tuple[Any, Any]:
        """Inputs for the next adapt step: a copy of the published
        (table, opt_state), the writer's to change in place.  Raises if a
        staged generation is pending."""
        with self._write_lock:
            if self._shadow is not None:
                raise RuntimeError(
                    "begin_adapt with a staged generation pending — "
                    "publish() or drop_staged() first")
            snap = self._published
            return clone_tree(snap.table), clone_tree(snap.opt_state)

    def stage(self, table, opt_state) -> None:
        """Land an adapt result in the shadow generation; not visible to
        readers until ``publish``."""
        with self._write_lock:
            if self._shadow is not None:
                raise RuntimeError("stage called twice without publish()")
            self._shadow = (table, opt_state)

    def publish(self, *, block: bool = True) -> Snapshot:
        """Swap the staged generation in.  ``block=True`` records an event
        after the work queued on the current stream (the staged writes)
        and waits on it first, so no reader can gather from a buffer the
        card is still writing.  ``block=False`` is for callers that
        already waited (``timed_adapt``)."""
        with self._write_lock:
            if self._shadow is None:
                raise RuntimeError("publish with nothing staged")
            table, opt_state = self._shadow
            if block and torch.cuda.is_initialized():
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            snap = Snapshot(table, opt_state, self._published.version + 1)
            # the one atomic step: readers see old-complete or
            # new-complete, nothing in between
            self._published = snap
            self._shadow = None
            return snap

    def drop_staged(self) -> None:
        """Abandon a staged generation (failed or aborted adapt)."""
        with self._write_lock:
            self._shadow = None
