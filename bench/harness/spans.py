"""Device time that no program span holds, from a reduced trace
(``harness.trace.Trace``): the device operations launched outside every
host span whose name starts with ``obs.`` (the program's spans,
``repro_torch.obs.profiling.scope``), optionally only those launched
inside one of the benchmark's own spans.  A launch at either end of a
span counts as inside it, as in ``Trace.span_device_s``."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

PROGRAM = "obs."


def _merged(iv) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _inside(merged, starts, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def unspanned_s(tr, within: Optional[str] = None) -> Optional[float]:
    """Seconds of the device operations launched outside every program
    span and, when ``within`` names a span, inside it.  None when the
    trace has no program span (inside ``within``): the program then has
    no spans to leave anything out of."""
    spans = _merged(iv for name, ivs in tr.spans.items()
                    if name.startswith(PROGRAM) for iv in ivs)
    outer = None
    if within is not None:
        outer = _merged(tr.spans.get(within, []))
        ostarts = [a for a, _b in outer]
        spans = [iv for iv in spans if _inside(outer, ostarts, iv[0])]
    if not spans:
        return None
    starts = [a for a, _b in spans]
    total = 0.0
    for _name, _ts, dur, t in tr.ops:
        if outer is not None and not _inside(outer, ostarts, t):
            continue
        if not _inside(spans, starts, t):
            total += dur
    return total * 1e-6
