"""Reproducible zipf traffic traces for the serving replay.

Counterpart of ``repro.serve.traffic``, numpy only: the same config gives
the reference's trace bit for bit (ids, rows, arrivals, users).

A trace is a list of ``AdaptRequest``s with monotone virtual arrival
times: ``n_requests`` user feedback steps, each touching
``ids_per_request`` embedding rows drawn zipf(alpha) over the table, the
row-popularity model the planner's error bounds assume.  Hot ranks are
scattered across the physical row space by a fixed seeded permutation
(rank 0 is not row 0).  Arrivals: ``poisson`` (i.i.d. exponential gaps
at ``offered_load`` req/s, the open-loop model under which p99 and shed
rate mean something) or ``uniform`` (fixed spacing).  Everything derives
from ``TraceConfig.seed`` through one ``RandomState``, so the dense and
count-min arms replay the same request sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.serve.batcher import AdaptRequest


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 512
    n_users: int = 256
    n_rows: int = 4096          # embedding-table rows the trace targets
    dim: int = 32
    ids_per_request: int = 8
    alpha: float = 1.1          # zipf exponent over row popularity
    offered_load: float = 1000.0   # requests/s on the virtual clock
    arrival: str = "poisson"    # 'poisson' | 'uniform'
    grad_scale: float = 0.1
    seed: int = 0


def make_trace(cfg: TraceConfig) -> List[AdaptRequest]:
    """Generate the full request list, sorted by arrival time."""
    if cfg.arrival not in ("poisson", "uniform"):
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    rng = np.random.RandomState(cfg.seed)

    # zipf CDF over popularity ranks, ranks scattered over physical rows
    ranks = np.arange(1, cfg.n_rows + 1, dtype=np.float64) ** -cfg.alpha
    cdf = np.cumsum(ranks / ranks.sum())
    rank_to_row = rng.permutation(cfg.n_rows).astype(np.int32)

    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.offered_load, size=cfg.n_requests)
    else:
        gaps = np.full((cfg.n_requests,), 1.0 / cfg.offered_load)
    arrivals = np.cumsum(gaps)

    users = rng.randint(0, cfg.n_users, size=cfg.n_requests)
    out: List[AdaptRequest] = []
    for i in range(cfg.n_requests):
        r = np.searchsorted(cdf, rng.rand(cfg.ids_per_request))
        ids = rank_to_row[np.minimum(r, cfg.n_rows - 1)]
        rows = (rng.standard_normal((cfg.ids_per_request, cfg.dim))
                * cfg.grad_scale).astype(np.float32)
        out.append(AdaptRequest(user=int(users[i]), ids=ids,
                                grad_rows=rows,
                                t_arrival=float(arrivals[i])))
    return out


def trace_stats(trace: List[AdaptRequest]) -> Dict[str, float]:
    """Summary the benchmark records next to its latency curves: how
    heavy the cross-request duplication actually is (the dedup win) and
    the realized span of the virtual clock."""
    all_ids = np.concatenate([np.asarray(r.ids) for r in trace])
    n_total = int(all_ids.size)
    n_unique = int(np.unique(all_ids).size)
    return {
        "n_requests": len(trace),
        "total_ids": n_total,
        "unique_ids": n_unique,
        "dup_ratio": round(n_total / max(n_unique, 1), 4),
        "span_s": round(float(trace[-1].t_arrival - trace[0].t_arrival), 6)
        if trace else 0.0,
    }
