"""Count-Min cleaning heuristic (paper §4) and the async cleaner.

Counterpart of ``repro.core.cleaning``.  Every ``every`` steps the
Count-Min sketch is multiplied by ``alpha``, before that step's reads.
The step counter lives on the host, so the decision costs no device sync;
the decay (``sketch.decay``) multiplies the sketch IN PLACE, and an int8
sketch decays through its block scales alone.

Two modes:

  * ``sync``  - the store's ``clean`` hook decays inside the step;
  * ``async`` - the hook does nothing and an ``AsyncCleaner``, owned by
    the training loop, decays between steps on a side CUDA stream.  The
    main stream waits on the decay's event before it runs anything more,
    so the step that follows reads the decayed sketch: the same numbers
    as ``sync``, to the bit, while the host never blocks.  On the CPU the
    decay runs at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import sketch as cs
from repro_torch.core.quantize import QuantState

_MODES = ("sync", "async")


@dataclasses.dataclass(frozen=True)
class CleaningSchedule:
    alpha: float = 0.2
    every: int = 125
    mode: str = "sync"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"cleaning mode must be one of {_MODES}, "
                             f"got {self.mode!r}")

    def due(self, step) -> bool:
        """Whether the decay fires on ``step`` (an int or a host tensor)."""
        step = int(step)
        return step > 0 and step % self.every == 0

    def apply(self, S, step):
        """Decay ``S`` in place on steps where ``step % every == 0``."""
        if self.due(step):
            S = cs.decay(S, self.alpha)
        return S


def maybe_clean(schedule: Optional[CleaningSchedule], S, step):
    """The in-step cleaning hook; a no-op for ``async`` schedules, whose
    ``AsyncCleaner`` decays between steps."""
    if schedule is None or schedule.mode == "async":
        return S
    return schedule.apply(S, step)


def _state_leaves(tree):
    """The sketch states of a tree of dicts, lists, tensors, ``QuantState``s
    and None."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _state_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QuantState):
        return [x for v in tree for x in _state_leaves(v)]
    return [tree]


def _tensors(state):
    return list(state) if isinstance(state, QuantState) else [state]


class AsyncCleaner:
    """Runs the §4 decay of an ``async`` schedule between steps.

    Call ``opt_state, fired = cleaner.maybe_dispatch(opt_state,
    next_step)`` before the step that will see counter ``next_step``: on
    the steps a sync schedule would decay, it decays every sketch state
    under ``getter(opt_state)`` (default ``opt_state["v"]``, a state or a
    tree of them) in place.  For CUDA states the decay goes on a side
    stream that first waits for the work already queued on the current
    stream; the current stream then waits on the decay's event, so
    whatever is queued after it (the step) reads the decayed sketch.
    ``in_flight()`` reports whether that event is still pending.  The
    states are updated in place, so ``opt_state`` comes back as it went
    in (the reference's ``setter`` has nothing to rebind); the decayed
    tensors are recorded on the side stream, so the allocator does not
    reuse them before the decay ends."""

    def __init__(self, schedule: CleaningSchedule, *,
                 getter: Optional[Callable[[Any], Any]] = None):
        if schedule.mode != "async":
            raise ValueError("AsyncCleaner needs a schedule with "
                             "mode='async'")
        self.schedule = schedule
        self._get = getter or (lambda st: st["v"])
        self._event: Optional[torch.cuda.Event] = None
        self._streams = {}
        self.dispatched = 0

    def due(self, next_step: int) -> bool:
        return self.schedule.due(next_step)

    def _side_stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def maybe_dispatch(self, opt_state, next_step: int):
        """Decay the count-min states when ``next_step`` is a cleaning
        step.  Returns ``(opt_state', fired)``; never blocks the host."""
        if not self.due(int(next_step)):
            return opt_state, False
        states = _state_leaves(self._get(opt_state))
        cuda = [s for s in states if cs.device_of(s).type == "cuda"]
        for s in states:
            if cs.device_of(s).type != "cuda":
                cs.decay(s, self.schedule.alpha)
        if cuda:
            dev = cs.device_of(cuda[0])
            main = torch.cuda.current_stream(dev)
            side = self._side_stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for s in cuda:
                    cs.decay(s, self.schedule.alpha)
                    for t in _tensors(s):
                        t.record_stream(side)
                event = torch.cuda.Event()
                event.record(side)
            main.wait_event(event)
            self._event = event
        self.dispatched += 1
        return opt_state, True

    def in_flight(self) -> bool:
        """Whether the last dispatched decay is still running on the
        card."""
        if self._event is None:
            return False
        if self._event.query():
            self._event = None
            return False
        return True
