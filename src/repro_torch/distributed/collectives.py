"""Collectives over a data-parallel axis: the port's counterpart of
``jax.lax.psum``/``pmean``/``all_gather`` over a named mesh axis.

A ``dp_axis`` of the port is an object with ``size``, ``rank``,
``psum(t)``, ``pmean(t)`` and ``all_gather(t)``, called from inside one
replica's step body.  Two kinds exist:

  * ``ProcessGroupAxis(group)`` - one replica a process, over
    ``torch.distributed`` (gloo on the CPU, NCCL on a card).  The step
    bodies of a ``dp_axis`` factory take the string name of the
    reference's mesh axis to mean the default process group
    (``as_axis``).
  * ``ReplicaGroup(R)`` - R replicas in R threads of one process, the
    counterpart of the reference's ``vmap(axis_name=...)``.  A barrier
    joins the replicas at each collective; ``psum`` adds their tensors in
    rank order, so every replica computes the same bits, and each replica
    gets its own copy of a result, since the steps write their state in
    place.  This is how R > 1 replicas run on one card: NCCL refuses two
    ranks on one device.

    group = ReplicaGroup(4)
    outs = group.run(step_fn, [(table[r], state[r], ids[r], rows[r])
                               for r in range(4)])

Every collective returns a new tensor and leaves its input as it was.
The threads of a ``ReplicaGroup`` launch on the default CUDA stream,
which they share, so the barrier also orders on the card what one
replica reads of another's tensor before that replica writes it again.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.kernels.ref import true_div


class ProcessGroupAxis:
    """A data-parallel axis over the processes of a ``torch.distributed``
    group (None: the default group), read when a collective runs, so the
    axis can be made before ``init_process_group``."""

    def __init__(self, group=None):
        self.group = group

    @property
    def size(self) -> int:
        return torch.distributed.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return torch.distributed.get_rank(self.group)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()                 # all_reduce overwrites its input
        torch.distributed.all_reduce(out, group=self.group)
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return true_div(self.psum(t), float(self.size))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every replica's ``t`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        torch.distributed.all_gather(parts, t, group=self.group)
        return torch.stack(parts)


class ReplicaGroup:
    """``size`` replicas of one step body in ``size`` threads of this
    process (see the module docstring).  ``timeout``: seconds a replica
    waits at a collective for the others before the group breaks (None:
    no limit)."""

    def __init__(self, size: int, timeout: Optional[float] = None):
        if size < 1:
            raise ValueError(f"a replica group needs size >= 1, got {size}")
        self.size = int(size)
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: List[Any] = [None] * self.size
        self._local = threading.local()

    @property
    def rank(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("a ReplicaGroup's collectives run inside "
                               "ReplicaGroup.run, in a replica's thread")
        return rank

    def _collect(self, t: torch.Tensor, combine: Callable) -> torch.Tensor:
        """``combine`` of every replica's ``t`` in rank order, computed by
        each replica for itself.  The second wait keeps each input
        untouched until every replica has read it."""
        self._slots[self.rank] = t
        self._barrier.wait()
        out = combine(list(self._slots))
        self._barrier.wait()
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        def add_in_rank_order(parts):
            out = parts[0].clone()
            for p in parts[1:]:
                out.add_(p)
            return out
        return self._collect(t, add_in_rank_order)

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return true_div(self.psum(t), float(self.size))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every replica's ``t`` in rank order."""
        return self._collect(t, torch.stack)

    def run(self, fn: Callable, args: Sequence[Sequence[Any]]) -> list:
        """``fn(*args[r])`` in replica r's thread, for every r; returns the
        results in rank order.  A replica that fails breaks the barrier,
        so the others stop at their next collective, and ``run`` raises
        the first failure (the others' ``BrokenBarrierError`` only when
        nothing else failed)."""
        if len(args) != self.size:
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{self.size} replicas")
        results: List[Any] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size

        def body(rank: int) -> None:
            self._local.rank = rank
            done = False
            try:
                results[rank] = fn(*args[rank])
                done = True
            except Exception as e:      # handed to the caller's thread
                errors[rank] = e
            finally:
                if not done:
                    self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"replica-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size
        failed = [e for e in errors if e is not None]
        if failed:
            self._barrier.reset()
            raise next((e for e in failed if not isinstance(
                e, threading.BrokenBarrierError)), failed[0])
        return results


def as_axis(dp_axis):
    """The collectives object of a ``dp_axis`` argument: None stays None,
    a string (the reference's mesh-axis name) is the default process
    group, and an axis object is itself."""
    if dp_axis is None:
        return None
    if isinstance(dp_axis, str):
        return ProcessGroupAxis()
    for name in ("psum", "pmean", "all_gather"):
        if not callable(getattr(dp_axis, name, None)):
            raise TypeError(f"dp_axis must be None, a string or an axis "
                            f"with size, rank, psum, pmean and all_gather; "
                            f"{type(dp_axis).__name__} has no {name!r}")
    return dp_axis
