"""Operation counts of one eager step: FLOPs, bytes and collectives.

Counterpart of ``repro.launch.hlo_cost``, which rebuilds the three
roofline inputs from XLA's optimized HLO text.  The port's steps run
eagerly, so ``OpCost``, a ``TorchDispatchMode``, counts every aten op
as it executes, on the ``meta`` device (shapes only, nothing allocated)
or on a card:

  * **FLOPs** of the dot-like ops only, as ``hlo_cost`` counts ``dot``:
    ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and the fused
    attention ops, by ``torch.utils.flop_counter``'s formulas (an
    ``einsum`` counts as the products it decomposes into).  A loop's
    body counts once per trip and ``torch.utils.checkpoint``'s recompute
    when it runs: the two things ``hlo_cost`` had to recover from the
    HLO (trip counts, remat) are simply what executes.  Elementwise ops
    and the sketch ops (gathers, scatters, the hand-written kernels,
    which are no aten ops) count no FLOPs, as in the reference, whose
    Pallas calls are opaque to ``hlo_cost``.  Flash attention's kernels
    are the exception: they report (``obs.profiling.kernel_work``,
    ``record_kernel``) the FLOPs of the einsums they stand for, so a
    step counts the same FLOPs on a card as on ``meta``.
  * **Bytes**: the operands and results of every aten op that is not a
    view and not a bare allocation, and of every reported kernel.  Every
    op is its own kernel here, so this is an unfused upper bound; the
    reference counts bytes at the granularity of XLA's fusions, so the
    two byte counts differ by design (``dryrun`` records their ratio
    where a reference record exists).
  * **Collectives**: a ``StandInAxis`` of size g is a ``dp_axis`` that
    needs no process group.  It returns results of the right shapes
    and records each ``psum``/``pmean`` (an all-reduce) and
    ``all_gather`` under the reference's ring model
    (``analysis.ring_link_bytes``).

``OpCost(sources=True)`` also keeps a row for each (op, source): the
innermost ``obs.*`` scope (``obs.profiling.scope``) and the innermost
frame of this package, or the autograd node in a backward pass; with
``label=True`` each counted aten op runs inside a ``record_function``
named after its row, so a profiler attributes device time to rows
(``breakdown``).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.analysis import COLLECTIVES, ring_link_bytes

aten = torch.ops.aten
# ops that move no byte: bare allocations, and a view that its schema
# does not mark as one
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)
# frames that stand between a counted op or kernel and its caller
_RELAYS = (_HERE, os.path.join(_PACKAGE, "obs", "profiling.py"))
LABEL = "op_cost#"


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.nbytes for t in leaves if isinstance(t, torch.Tensor))


def _empty_collectives() -> Dict[str, Dict]:
    return {k: {"count": 0, "bytes": 0.0, "link_bytes": 0.0}
            for k in COLLECTIVES}


@dataclasses.dataclass
class Row:
    """One (op, source) of a counted step."""

    op: str
    source: str
    index: int
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class OpCost(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of the ops run inside it.

        with OpCost() as cost:
            step_fn(params, opt_state, batch)
        cost.flops, cost.bytes, cost.collectives, cost.collective_link_bytes
    """

    def __init__(self, *, sources: bool = False, label: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = _empty_collectives()
        self.rows: Optional[Dict[Tuple[str, str], Row]] = \
            {} if sources or label else None
        # (kind g=..., source) -> [count, bytes, link bytes]
        self.collective_rows: Dict[Tuple[str, str], List[float]] = {}
        self.label = label
        self._scopes: List[str] = []
        self._registry = _flop_registry()

    @property
    def collective_link_bytes(self) -> float:
        return sum(v["link_bytes"] for v in self.collectives.values())

    def _source(self) -> str:
        scope = self._scopes[-1] if self._scopes else "-"
        node = torch._C._current_autograd_node()
        if node is not None:
            return f"{scope} backward:{node.name()}"
        f = sys._getframe(1)
        while f is not None:
            path = os.path.abspath(f.f_code.co_filename)
            if path.startswith(_PACKAGE) and path not in _RELAYS:
                rel = os.path.relpath(path, _PACKAGE)
                return f"{scope} {rel}:{f.f_lineno} {f.f_code.co_name}"
            f = f.f_back
        return scope

    def record_collective(self, kind: str, result: torch.Tensor,
                          g: int) -> None:
        """One collective of ``kind`` with this result, in a group of
        ``g``: its count, result bytes and ring-model link bytes."""
        if g <= 1:
            return
        nbytes = result.nbytes
        link = ring_link_bytes(kind, nbytes, g)
        c = self.collectives[kind]
        c["count"] += 1
        c["bytes"] += nbytes
        c["link_bytes"] += link
        if self.rows is not None:
            row = self.collective_rows.setdefault(
                (f"{kind} g={g}", self._source()), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += nbytes
            row[2] += link

    def _row(self, op: str) -> Optional[Row]:
        """The row of ``op`` at its source, made on first use; None
        without rows."""
        if self.rows is None:
            return None
        key = (op, self._source())
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = Row(*key, index=len(self.rows))
        return row

    def _add(self, row: Optional[Row], flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if row is not None:
            row.count += 1
            row.flops += flops
            row.bytes += nbytes

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of the hand-written kernel ``name`` (through
        ``obs.profiling.kernel_work``).  Its row carries no label: the
        profiler does not tie such a kernel's device time to a host span,
        so ``breakdown`` counts that time outside the rows."""
        self._add(self._row(name), flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":
            if "enter" in func.name():
                self._scopes.append(str(args[0]))
            elif self._scopes:
                self._scopes.pop()
            return func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return func(*args, **kwargs)
        row = self._row(str(func.overloadpacket))
        if self.label:
            with torch.profiler.record_function(f"{LABEL}{row.index}"):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0.0
        if packet in self._registry:
            flops = float(self._registry[packet](*args, **kwargs,
                                                 out_val=out))
        self._add(row, flops,
                  float(_tensor_bytes((args, kwargs)) + _tensor_bytes(out)))
        return out


class StandInAxis:
    """A ``dp_axis`` of ``size`` replicas that needs no process group:
    each collective returns a result of the right shape (as if every
    replica held this one's tensor) and is recorded in ``cost``."""

    def __init__(self, size: int, cost: OpCost, rank: int = 0):
        self.size, self.rank, self.cost = int(size), int(rank), cost

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        out = t * self.size
        self.cost.record_collective("all-reduce", out, self.size)
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        self.cost.record_collective("all-reduce", out, self.size)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = t.unsqueeze(0).expand(self.size, *t.shape).clone()
        self.cost.record_collective("all-gather", out, self.size)
        return out
