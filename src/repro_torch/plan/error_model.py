"""CMS/CS collision-error model under power-law row traffic.

The port's own copy of ``repro.plan.error_model`` (pure numpy, float64
on the host), so a plan's ``predicted_error`` equals the reference's to
the bit.  For every candidate (depth, width) the planner needs a scalar
that falls with width, is weighted by the table's traffic and is cheap
for tables of tens of millions of rows.  Row access follows a Zipf power
law (the paper's Fig. 1-2), so the model reduces to the Herfindahl
concentration ``H = Σ fᵢ²`` of the normalised access frequencies:

* **Count-Min** (min over depth): expected colliding-mass fraction
  ``(1 - H) / (width · depth)``;
* **Count-Sketch** (median over depth): relative std
  ``√(H / width) / √depth``;
* **rank-1** (LR-NMF-V): ``RANK1_REL_ERROR``, independent of the budget.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# Tail-mean relative error of the NMF rank-1 reconstruction of the 2nd
# moment in benchmarks/approx_error.py's protocol (paper Fig. 4): the
# rank-1 candidate is cheap but its error does not shrink with budget.
RANK1_REL_ERROR = 0.35

# Explicitly materialized head of the zipf sum; the tail is integrated.
_ZIPF_HEAD = 100_000


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Per-table row-access statistics the planner consumes.

    Either an assumed Zipf exponent ``alpha`` (the ``data.pipeline``
    stream's marginal; word frequencies ≈ 1.0–1.2) or measured id
    ``freqs`` (unnormalized counts, e.g. from ``measure_freqs``).
    ``weight`` scales this table's contribution to the global objective
    relative to its ``rows·dim`` size (default 1.0)."""

    alpha: float = 1.1
    freqs: Optional[np.ndarray] = None
    weight: float = 1.0

    def herfindahl(self, n: int) -> float:
        """Σ fᵢ² of the (normalized) access frequencies over ``n`` rows."""
        if self.freqs is not None:
            f = np.asarray(self.freqs, np.float64)
            tot = float(f.sum())
            if tot <= 0.0:
                return 1.0 / max(n, 1)
            f = f / tot
            return float(np.sum(f * f))
        h1 = zipf_power_sum(n, self.alpha)
        h2 = zipf_power_sum(n, 2.0 * self.alpha)
        return h2 / (h1 * h1)


def zipf_power_sum(n: int, a: float) -> float:
    """``Σ_{r=1..n} r^-a`` — explicit head + integral tail, so 50M-row
    extreme-classification tables cost microseconds, not arrays."""
    n = int(n)
    head = min(n, _ZIPF_HEAD)
    s = float(np.sum(np.arange(1, head + 1, dtype=np.float64) ** (-a)))
    if n > head:
        if abs(a - 1.0) < 1e-9:
            s += math.log((n + 0.5) / (head + 0.5))
        else:
            s += ((n + 0.5) ** (1.0 - a) - (head + 0.5) ** (1.0 - a)) / (1.0 - a)
    return s


def countmin_error(stats: TableStats, n: int, width: int, depth: int) -> float:
    """Traffic-weighted expected colliding-mass fraction of a Count-Min
    query (the unsigned 2nd-moment sketch)."""
    H = stats.herfindahl(n)
    return (1.0 - H) / (max(width, 1) * max(depth, 1))


def countsketch_error(stats: TableStats, n: int, width: int,
                      depth: int) -> float:
    """Relative std of the signed Count-Sketch median estimate (the
    1st-moment sketch)."""
    H = stats.herfindahl(n)
    return math.sqrt(H / max(width, 1)) / math.sqrt(max(depth, 1))


def rank1_error(stats: TableStats, n: int) -> float:
    """Model error of the NMF rank-1 2nd moment — budget-independent."""
    return RANK1_REL_ERROR


def measure_freqs(batches, n_rows: int, *, key: str = "tokens") -> np.ndarray:
    """Measured id frequencies from an iterable of ``data.pipeline``
    batches (dicts with an int id array under ``key``) — the "measured"
    alternative to an assumed zipf exponent."""
    counts = np.zeros((n_rows,), np.int64)
    for batch in batches:
        ids = np.asarray(batch[key]).ravel()
        counts += np.bincount(ids, minlength=n_rows)[:n_rows]
    return counts
