"""Straggler monitoring (host-side control plane).

Counterpart of ``repro.distributed.elastic``'s ``StragglerMonitor``,
which the trainer records every step time into: an EWMA of each host's
step time, flagging hosts slower than ``threshold`` times the fleet
median.  The module's resize planning, elastic restore and recovery
loop (``plan_resize``, ``elastic_restore``, ``recovery_loop``) need a
mesh and wait for ROADMAP A13c.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker with median-relative flagging."""

    threshold: float = 1.5      # flag hosts slower than 1.5x fleet median
    alpha: float = 0.2          # EWMA smoothing
    min_samples: int = 5
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _count: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (step_time if prev is None
                            else self.alpha * step_time
                            + (1 - self.alpha) * prev)
        self._count[host] = self._count.get(host, 0) + 1

    def median(self) -> Optional[float]:
        vals = sorted(self._ewma.values())
        if not vals:
            return None
        n = len(vals)
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1]
                                                 + vals[n // 2])

    def stragglers(self) -> List[int]:
        med = self.median()
        if med is None or med == 0.0:
            return []
        return sorted(
            h for h, t in self._ewma.items()
            if self._count.get(h, 0) >= self.min_samples
            and t > self.threshold * med)


def _needs_a13(name: str):
    raise NotImplementedError(
        f"{name} re-plans a mesh after losing devices, which is not "
        f"ported yet (ROADMAP A13c)")


def plan_resize(*args, **kwargs):
    _needs_a13("plan_resize")


def elastic_restore(*args, **kwargs):
    _needs_a13("elastic_restore")


def recovery_loop(*args, **kwargs):
    _needs_a13("recovery_loop")
