"""Count-Min cleaning heuristic (paper §4), sync mode.

Counterpart of the sync half of ``repro.core.cleaning``: every ``every``
steps the Count-Min sketch is multiplied by ``alpha``, before that step's
reads.  The step counter lives on the host, so the decision costs no
device sync; the decay multiplies the sketch IN PLACE.  The async cleaner
of the reference is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CleaningSchedule:
    alpha: float = 0.2
    every: int = 125

    def due(self, step) -> bool:
        """Whether the decay fires on ``step`` (an int or a host tensor)."""
        step = int(step)
        return step > 0 and step % self.every == 0

    def apply(self, S: torch.Tensor, step) -> torch.Tensor:
        """Decay ``S`` in place on steps where ``step % every == 0``."""
        if self.due(step):
            S.mul_(self.alpha)
        return S


def maybe_clean(schedule: Optional[CleaningSchedule], S: torch.Tensor, step
                ) -> torch.Tensor:
    """The in-step cleaning hook."""
    if schedule is None:
        return S
    return schedule.apply(S, step)
