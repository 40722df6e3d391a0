"""Greedy water-filling allocator: bytes -> per-leaf compression plan.

Counterpart of ``repro.plan.allocator``, the same integers and Python
floats in the same order, so its plans equal the reference's leaf for
leaf.  Every leaf gets a Pareto ladder of candidates: ``dense`` (error
0, the most bytes), ``sketch`` at (depth, width) on a geometric ladder
of ``width_multiple`` multiples up to the identity point, and ``rank1``
(LR-NMF-V) where its (n,) + (d,) factors undercut the dense 2nd moment.
Leaves that are not rank 2, have too few rows, or have neither traffic
stats nor a sparse-table name stay dense.  The solve starts every leaf
at its cheapest candidate (the floor; below it the budget is
infeasible), applies the upgrade with the best ``error drop x weight /
extra bytes`` that still fits until none does (ties broken by ``(drop,
-leaf, -candidate)``), then solves the hottest sketched leaf's width
exactly from the leftover bytes (``sketch.for_budget``).  At a budget
that covers the dense cost every leaf ends dense.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import sketch as cs
from repro_torch.core.partition import (MIN_SKETCH_ROWS,
                                        SPARSE_TABLE_PATTERN, leaf_paths)
from repro_torch.plan import accounting, error_model
from repro_torch.plan.accounting import dtype_name
from repro_torch.plan.error_model import TableStats
from repro_torch.plan.plan import (InfeasibleBudgetError, LeafPlan, Plan,
                                   MODE_DENSE, MODE_RANK1, MODE_SKETCH)


@dataclasses.dataclass(frozen=True)
class Candidate:
    mode: str
    depth: int
    width: int
    bytes_m: int
    bytes_v: int
    error: float

    @property
    def nbytes(self) -> int:
        return self.bytes_m + self.bytes_v


def _sketch_candidate(shape, dtype, stats: TableStats, depth: int,
                      width: int, *, sketch_dtype: str,
                      track_first_moment: bool,
                      sketch_first_moment: bool) -> Candidate:
    sm, sv = accounting.sketch_leaf_bytes(
        shape, dtype, depth, width, sketch_dtype=sketch_dtype,
        track_first_moment=track_first_moment,
        sketch_first_moment=sketch_first_moment)
    n = int(shape[0])
    err = error_model.countmin_error(stats, n, width, depth)
    if track_first_moment and sketch_first_moment:
        err += error_model.countsketch_error(stats, n, width, depth)
    return Candidate(MODE_SKETCH, depth, width, sm, sv, err)


def _pareto(cands: List[Candidate]) -> List[Candidate]:
    """Sort by bytes ascending, keep only strictly-improving error."""
    cands = sorted(cands, key=lambda c: (c.nbytes, c.error))
    out: List[Candidate] = []
    for c in cands:
        if not out:
            out.append(c)
        elif c.error < out[-1].error - 1e-18:
            if c.nbytes == out[-1].nbytes:
                out[-1] = c
            else:
                out.append(c)
    return out


def leaf_candidates(path: str, shape: Tuple[int, ...], dtype, *,
                    stats: Optional[TableStats], depth: int = 3,
                    width_multiple: int = 256, sketch_dtype: str = "float32",
                    min_rows: int = MIN_SKETCH_ROWS,
                    track_first_moment: bool = True,
                    sketch_first_moment: bool = True) -> List[Candidate]:
    """The Pareto candidate ladder for one leaf (cheapest first)."""
    bm, bv = accounting.dense_leaf_bytes(
        shape, dtype, track_first_moment=track_first_moment)
    dense = Candidate(MODE_DENSE, 0, 0, bm, bv, 0.0)

    compressible = (len(shape) == 2 and shape[0] >= min_rows
                    and (stats is not None
                         or SPARSE_TABLE_PATTERN.search(path) is not None))
    if not compressible:
        return [dense]
    st = stats if stats is not None else TableStats()
    n = int(shape[0])

    cands = [dense]
    rm, rv = accounting.rank1_leaf_bytes(
        shape, dtype, track_first_moment=track_first_moment)
    if rm + rv < dense.nbytes:
        cands.append(Candidate(MODE_RANK1, 0, 0, rm, rv,
                               error_model.rank1_error(st, n)))

    cap = -(-n // width_multiple) * width_multiple   # identity point
    widths = []
    w = width_multiple
    while w < cap:
        widths.append(w)
        w *= 2
    widths.append(cap)
    for w in widths:
        c = _sketch_candidate(shape, dtype, st, depth, w,
                              sketch_dtype=sketch_dtype,
                              track_first_moment=track_first_moment,
                              sketch_first_moment=sketch_first_moment)
        if c.nbytes >= dense.nbytes:
            break
        cands.append(c)
    return _pareto(cands)


def _device_cost(c: Candidate, shards: int) -> int:
    """One device's bytes for a candidate: sketch state splits into
    ``shards`` equal slabs over the model axis; dense and
    rank-1 state is replicated, so it costs full bytes on every device.
    This is the cost the water-fill charges against the (per-device)
    budget when planning sharded."""
    if shards <= 1 or c.mode != MODE_SKETCH:
        return c.nbytes
    return -(-c.bytes_m // shards) + -(-c.bytes_v // shards)


def _check_shards(shards: int, width_multiple: int) -> int:
    shards = int(shards)
    if shards < 1:
        raise ValueError("shards must be >= 1")
    if shards > 1 and width_multiple % shards != 0:
        raise ValueError(
            f"width_multiple ({width_multiple}) must be divisible by the "
            f"shard count ({shards}) so every ladder width splits into "
            f"equal slabs")
    return shards


def water_fill(ladders: Sequence[List[Candidate]],
               weights: Sequence[float], budget: int,
               *, cost=None) -> List[int]:
    """Pick one candidate per leaf (index into its ladder), total bytes ≤
    budget, by greedy best-ratio upgrades from the floor.  ``cost`` maps
    a candidate to the bytes it charges (default: total bytes; the
    sharded planner passes per-device cost)."""
    if cost is None:
        cost = lambda c: c.nbytes   # noqa: E731
    idx = [0] * len(ladders)
    total = sum(cost(lad[0]) for lad in ladders)
    if total > budget:
        raise InfeasibleBudgetError(budget, total)
    while True:
        best = None     # (key, leaf, cand, extra)
        for i, lad in enumerate(ladders):
            cur = lad[idx[i]]
            for j in range(idx[i] + 1, len(lad)):
                extra = cost(lad[j]) - cost(cur)
                if extra > budget - total:
                    continue
                drop = (cur.error - lad[j].error) * weights[i]
                key = (drop / max(extra, 1), drop, -i, -j)
                if best is None or key > best[0]:
                    best = (key, i, j, extra)
        if best is None:
            break
        _, i, j, extra = best
        idx[i] = j
        total += extra
    return idx


def _stats_for(path: str, stats: Dict[str, TableStats],
               default_alpha: float) -> Optional[TableStats]:
    st = stats.get(path)
    if st is None and SPARSE_TABLE_PATTERN.search(path):
        st = TableStats(alpha=default_alpha)
    return st


def plan_for_params(params_like, budget_bytes: int, *,
                    stats: Optional[Dict[str, TableStats]] = None,
                    default_alpha: float = 1.1, depth: int = 3,
                    width_multiple: int = 256, sketch_dtype: str = "float32",
                    min_rows: int = MIN_SKETCH_ROWS, seed: int = 0,
                    track_first_moment: bool = True,
                    sketch_first_moment: bool = True,
                    shards: int = 1, shard_layout: str = "width") -> Plan:
    """Solve a per-leaf compression plan for ``params_like`` (arrays or
    ``accounting.ShapeDtype`` records) under an aux-memory budget in bytes.

    ``stats`` maps leaf paths to measured/assumed ``TableStats``; leaves
    without an entry fall back to Zipf(``default_alpha``) if their path
    matches the sparse-table pattern, else stay dense.

    ``shards > 1`` plans MODEL-PARALLEL sketches: the
    budget becomes a PER-DEVICE budget — each sketch candidate charges
    ``nbytes / shards`` (its slab), dense/rank-1 leaves charge full bytes
    (replicated) — so a table whose total sketch exceeds one device's
    budget still plans when its slab fits.  Requires
    ``width_multiple % shards == 0``."""
    budget = int(budget_bytes)
    shards = _check_shards(shards, width_multiple)
    if shard_layout not in ("width", "hash"):
        raise ValueError(f"unknown shard layout {shard_layout!r} "
                         f"(expected 'width' or 'hash')")
    cost = lambda c: _device_cost(c, shards)   # noqa: E731
    leaves = [(p, tuple(int(s) for s in l.shape), dtype_name(l.dtype))
              for p, l in leaf_paths(params_like)]
    stats = stats or {}

    ladders, weights, leaf_stats = [], [], []
    for path, shape, dtype in leaves:
        st = _stats_for(path, stats, default_alpha)
        leaf_stats.append(st)
        ladders.append(leaf_candidates(
            path, shape, dtype, stats=st, depth=depth,
            width_multiple=width_multiple, sketch_dtype=sketch_dtype,
            min_rows=min_rows, track_first_moment=track_first_moment,
            sketch_first_moment=sketch_first_moment))
        # traffic weight ∝ table volume × user multiplier
        size = 1
        for s in shape:
            size *= s
        weights.append(size * (st.weight if st is not None else 1.0))

    idx = water_fill(ladders, weights, budget, cost=cost)
    chosen = [lad[i] for lad, i in zip(ladders, idx)]

    # Top-up: the geometric ladder leaves sub-doubling slack; solve the
    # hottest sketched leaf's width exactly from the leftover bytes.
    # All byte arithmetic here is in per-device (``cost``) terms; the
    # per-moment budget handed to ``for_budget`` scales back up by
    # ``shards`` since it sizes the TOTAL (all-slab) width.
    remaining = budget - sum(cost(c) for c in chosen)
    for i in sorted(range(len(leaves)), key=lambda k: (-weights[k], k)):
        c = chosen[i]
        if c.mode != MODE_SKETCH or remaining <= 0:
            continue
        path, shape, dtype = leaves[i]
        bm_d, bv_d = accounting.dense_leaf_bytes(
            shape, dtype, track_first_moment=track_first_moment)
        dense_total = bm_d + bv_d
        n_sketched = 2 if (track_first_moment and sketch_first_moment) else 1
        spend = min(remaining, dense_total - 1 - cost(c))
        if spend <= 0:
            continue
        try:
            spec = cs.for_budget(shape,
                                 c.bytes_v + (spend * shards) // n_sketched,
                                 depth=c.depth, dtype=sketch_dtype,
                                 width_multiple=width_multiple)
        except ValueError:
            continue
        # clamp to the identity point: per-device cost can stay under
        # budget long past the width where extra buckets stop helping
        cap = -(-int(shape[0]) // width_multiple) * width_multiple
        new_width = min(spec.width, cap)
        if new_width <= c.width:
            continue
        st = leaf_stats[i] or TableStats(alpha=default_alpha)
        c2 = _sketch_candidate(shape, dtype, st, c.depth, new_width,
                               sketch_dtype=sketch_dtype,
                               track_first_moment=track_first_moment,
                               sketch_first_moment=sketch_first_moment)
        extra = cost(c2) - cost(c)
        if 0 < extra <= remaining and cost(c2) < dense_total:
            chosen[i] = c2
            remaining -= extra

    plan_leaves = []
    for (path, shape, dtype), c in zip(leaves, chosen):
        plan_leaves.append(LeafPlan(
            path=path, shape=shape, dtype=dtype, mode=c.mode,
            depth=c.depth, width=c.width, bytes_m=c.bytes_m,
            bytes_v=c.bytes_v, predicted_error=c.error))
    return Plan(leaves=tuple(plan_leaves), budget_bytes=budget,
                width_multiple=width_multiple, sketch_dtype=sketch_dtype,
                seed=seed, track_first_moment=track_first_moment,
                sketch_first_moment=sketch_first_moment,
                sketch_shards=shards, shard_layout=shard_layout)


def min_budget_bytes(params_like, *, stats=None, default_alpha: float = 1.1,
                     depth: int = 3, width_multiple: int = 256,
                     sketch_dtype: str = "float32",
                     min_rows: int = MIN_SKETCH_ROWS,
                     track_first_moment: bool = True,
                     sketch_first_moment: bool = True,
                     shards: int = 1) -> int:
    """The plan floor: total bytes with every leaf at its cheapest
    candidate.  Budgets below this raise ``InfeasibleBudgetError``.
    With ``shards > 1`` the floor is per-device (sketch floors split
    ``shards`` ways, replicated state does not)."""
    stats = stats or {}
    shards = _check_shards(shards, width_multiple)
    total = 0
    for path, leaf in leaf_paths(params_like):
        lad = leaf_candidates(
            path, tuple(int(s) for s in leaf.shape), dtype_name(leaf.dtype),
            stats=_stats_for(path, stats, default_alpha), depth=depth,
            width_multiple=width_multiple, sketch_dtype=sketch_dtype,
            min_rows=min_rows, track_first_moment=track_first_moment,
            sketch_first_moment=sketch_first_moment)
        total += _device_cost(lad[0], shards)
    return total
