"""Sketched gradient reduction for data parallelism.

Counterpart of the data-parallel half of
``repro.distributed.sketched_reduce``.  The count-sketch is linear, so
for a data-parallel embedding/softmax gradient the cross-replica sum
commutes with sketching:

    sketch(psum(g)) == psum(sketch(g))

Each replica inserts its LOCAL rows into a zero sketch and the
all-reduce moves ``depth·width·d`` cells instead of ``k·d`` rows
(``traffic_ratio`` prints the bytes; at small k the sketch is the larger
payload).  The 2nd moment needs ``psum(g)²``, which does not commute with
the sum of per-replica squares: ``reduce_moments`` sums the squares and,
given a ``residual``, adds the MicroAdam-style error feedback (each
replica's share of the cross term, estimated through the reduced
1st-moment sketch, banked in a residual sketch and injected while the
2nd-moment increment stays non-negative).

``dp_adam_rows`` is the per-replica CS-Adam step built on these
collectives, the body of ``train.steps.make_sparse_embedding_step(
dp_axis=...)``.  ``axis_name`` is a ``dp_axis`` of
``distributed.collectives`` (``ReplicaGroup``, ``ProcessGroupAxis``, or
a string for the default process group).  Sketches are written IN PLACE
as everywhere in the port: ``M``, ``V`` and ``residual`` are the
replica's own state, and every sketch a collective returns is the
replica's own copy.  On a card every ``sketch.update`` is B5's run
scatter (``kernels/cs_update.py``); the queries are the plain
``sketch.query``, as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as cs
from repro_torch.distributed.collectives import as_axis
from repro_torch.kernels import dedup as dd
from repro_torch.kernels.ops import bias_correction
from repro_torch.kernels.ref import true_div
from repro_torch.obs.profiling import scope

# out of range for any table: the padding of the global id set
FILL_ID = int(np.iinfo(np.int32).max)


def local_sketch(spec: cs.SketchSpec, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """This replica's (ids, rows) inserted into a zero sketch on the rows'
    device: the object that is all-reduced instead of (k, d)."""
    return cs.update(spec, cs.init(spec, rows.device), ids, rows)


def reduce_gradient_sketch(spec: cs.SketchSpec, ids: torch.Tensor,
                           rows: torch.Tensor, axis_name) -> torch.Tensor:
    """psum of per-replica sketches == sketch of the psum'd gradient."""
    local = local_sketch(spec, ids, rows)
    with scope("obs.collective"):
        return as_axis(axis_name).psum(local)


# ---------------------------------------------------------------------------
# Traffic accounting (bytes, not element counts)
# ---------------------------------------------------------------------------

def dense_reduce_bytes(n_rows: int, dim: int, *,
                       grad_dtype=torch.float32,
                       ids_dtype=torch.int32,
                       with_ids: bool = True) -> int:
    """Bytes the dense data-parallel path moves per replica to combine an
    (ids, rows) batch of ``n_rows`` touched rows: the rows, plus the ids
    that address them unless ``with_ids`` is False."""
    payload = n_rows * dim * grad_dtype.itemsize
    if with_ids:
        payload += n_rows * ids_dtype.itemsize
    return payload


def sketched_reduce_bytes(*specs: Optional[cs.SketchSpec]) -> int:
    """Bytes the sketched path all-reduces: every live sketch's
    ``nbytes()`` (1st-moment, 2nd-moment, error-feedback cross term)."""
    return sum(s.nbytes() for s in specs if s is not None)


def traffic_ratio(spec: cs.SketchSpec, n_rows: int, *,
                  grad_dtype=torch.float32,
                  with_ids: bool = True,
                  extra_specs: Tuple[Optional[cs.SketchSpec], ...] = ()
                  ) -> float:
    """Dense all-reduce bytes / sketched all-reduce bytes, dtype-aware,
    the dense side charged its ids.  ``extra_specs``: further sketches on
    the same collective (the 2nd moment, the cross term)."""
    dense = dense_reduce_bytes(n_rows, spec.dim, grad_dtype=grad_dtype,
                               with_ids=with_ids)
    return dense / sketched_reduce_bytes(spec, *extra_specs)


# ---------------------------------------------------------------------------
# 2nd-moment reduction with MicroAdam-style error feedback
# ---------------------------------------------------------------------------

def init_feedback(spec_v: cs.SketchSpec, device="cuda") -> torch.Tensor:
    """Zero error-feedback residual in the 2nd-moment sketch's geometry."""
    return cs.init(spec_v, device)


def _inject_feedback(g_v: torch.Tensor, residual: torch.Tensor,
                     cross_sketch: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bank this step's cross-term sketch into the residual, inject as
    much as keeps the count-min increment >= 0 per bucket, carry the
    rest.  ``g_v`` and ``residual`` are written IN PLACE and returned."""
    total = residual.add_(cross_sketch)
    inject = torch.maximum(total, -g_v)
    return g_v.add_(inject), total.sub_(inject)


def reduce_moments(spec_m: cs.SketchSpec, spec_v: cs.SketchSpec,
                   ids: torch.Tensor, rows: torch.Tensor, axis_name, *,
                   residual: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """(G_m, G_v, residual'): the all-reduced sketches of g and
    (approximately) g², and the error-feedback residual, updated IN PLACE.

    G_m is exact (linearity).  G_v sums the per-replica squares and misses
    the cross-replica terms of (Σ_r g_r)².  With ``residual`` (from
    ``init_feedback``) each replica's share ``g_r·(Σg − g_r)`` of the cross
    term, Σg read from the reduced G_m at its ids and the share clipped at
    ``−g_r²`` (every row's net contribution stays >= 0), is sketched,
    reduced, banked and injected (``_inject_feedback``).  Without it the
    bias is accepted and None is returned in its slot."""
    axis = as_axis(axis_name)
    g_m = reduce_gradient_sketch(spec_m, ids, rows, axis)
    sq = local_sketch(spec_v, ids, torch.square(rows))
    with scope("obs.collective"):
        g_v = axis.psum(sq)
    if residual is None:
        return g_m, g_v, None
    g_sum = cs.query(spec_m, g_m, ids)              # ≈ Σ_r g_r at local ids
    cross = torch.maximum(rows * (g_sum - rows),    # this replica's share,
                          -torch.square(rows))      # net non-negative a row
    local_c = local_sketch(spec_v, ids, cross)
    with scope("obs.collective"):
        g_c = axis.psum(local_c)
    g_v, residual = _inject_feedback(g_v, residual, g_c)
    return g_m, g_v, residual


# ---------------------------------------------------------------------------
# Global id set (the only non-sketch collective the DP step needs)
# ---------------------------------------------------------------------------

def global_unique_ids(local_ids: torch.Tensor, axis_name, *,
                      fill_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather each replica's (locally deduplicated, ``fill_id``-padded)
    ids and deduplicate across replicas.  Returns ``(uids, mask)`` of
    length ``R·k``: the sorted global unique ids, then ``fill_id``
    padding, and a float32 mask of the live slots.  Nothing is read on the
    host."""
    with scope("obs.collective"):
        gathered = as_axis(axis_name).all_gather(local_ids)     # (R, k)
    sorted_ids = torch.sort(gathered.reshape(-1).to(torch.int32)).values
    k, dev = sorted_ids.shape[0], sorted_ids.device
    live = sorted_ids != fill_id
    is_start = torch.ones((k,), dtype=torch.bool, device=dev)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    is_start &= live
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    # padding positions write to a spare slot k, so they cannot clobber
    # the last live slot (their seg still points at it)
    uids = torch.full((k + 1,), fill_id, dtype=torch.int32, device=dev)
    uids.scatter_(0, torch.where(live, seg, k), sorted_ids)
    n_unique = is_start.sum()
    mask = (torch.arange(k, device=dev) < n_unique).to(torch.float32)
    return uids[:k], mask


# ---------------------------------------------------------------------------
# The per-replica DP CS-Adam update
# ---------------------------------------------------------------------------

class DpAdamResult(NamedTuple):
    M: Optional[torch.Tensor]         # updated 1st-moment sketch
    V: torch.Tensor                   # updated 2nd-moment sketch
    residual: Optional[torch.Tensor]  # updated error-feedback residual
    uids: torch.Tensor                # (R·k,) global unique ids + padding
    rows: torch.Tensor                # (R·k, d) ascent direction a uid
    mask: torch.Tensor                # (R·k,) 1.0 for live slots


def dp_adam_rows(spec_m: Optional[cs.SketchSpec], spec_v: cs.SketchSpec,
                 M: Optional[torch.Tensor], V: torch.Tensor,
                 ids: torch.Tensor, rows: torch.Tensor, step, *,
                 axis_name, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 residual: Optional[torch.Tensor] = None,
                 fill_id: Optional[int] = None,
                 dir_clip: Optional[float] = 10.0) -> DpAdamResult:
    """One data-parallel CS-Adam step over a replicated (n, d) table whose
    gradient arrives as per-replica ``(ids, rows)`` shards; every replica
    of ``axis_name`` calls it with its own shard and its own copy of the
    replicated state, which is updated IN PLACE.  ``step`` is the host
    step counter.

    The collectives move sketches and the int32 ids, never gradient rows:
    the psum of the 1st-moment gradient sketches (exact by linearity: M
    evolves as the single-device step on the concatenated batch, to the
    bit under dyadic hyperparameters and integer gradients), the psum of
    the squared-row sketches (plus the error-feedback cross term, see
    ``reduce_moments``), and the all-gather of the locally deduplicated
    ids.  With ``spec_m`` None (β₁=0) ``spec_v``'s signed twin, every
    other field inherited, is the transient gradient sketch of the
    numerator.

    Emits the unscaled ascent direction at the global unique ids; the
    ``fill_id`` padding (default: int32 max, out of range for any table)
    carries zero rows and is dropped by
    ``optimizers.apply_unique_updates``.  ``dir_clip``: the per-coordinate
    trust clamp on the direction (both moments are sketch reads here, so
    estimator mismatch can exceed exact Adam's ~1-bounded ratio); None
    disables."""
    axis = as_axis(axis_name)
    track_m = spec_m is not None
    # replace(), not a field list: the g sketch must hash as spec_v does
    spec_g = spec_m if track_m else dataclasses.replace(spec_v, signed=True)
    if fill_id is None:
        fill_id = FILL_ID
    t = int(step)
    bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)

    # 1. local dedup: duplicates inside a replica batch are one gradient
    #    row, summed first so the intra-replica cross terms of g² are exact
    batch = dd.dedup_rows(ids, rows, fill_id=fill_id)
    lids, lrows = batch.unique_ids, batch.rows

    # 2. the sketch collectives and the error feedback
    G_g, G_v, residual = reduce_moments(spec_g, spec_v, lids, lrows, axis,
                                        residual=residual)

    # 3. the id collective: every replica learns the global touched set
    uids, mask = global_unique_ids(lids, axis, fill_id=fill_id)
    col = mask[:, None]

    # 4. the replicated state update: the single-device whole-batch
    #    update with the summed-gradient scatter replaced by its sketch
    #    identity sketch((1-β₁)·Σg at uids) == (1-β₁)·psum(local sketches).
    #    Every read of M, V, G_g and G_v precedes the in-place writes.
    if track_m:
        m_old = cs.query(spec_m, M, uids) * col
        ghat = cs.query(spec_g, G_g, uids) * col      # ≈ Σg at uids
        M = cs.update(spec_m, M.add_((1.0 - b1) * G_g), uids,
                      -(1.0 - b1) * m_old)
        mhat = true_div(m_old + (1.0 - b1) * (ghat - m_old), bc1)
    else:
        mhat = cs.query(spec_g, G_g, uids) * col
    v_old = cs.query(spec_v, V, uids) * col
    g2hat = cs.query(spec_v, G_v, uids) * col         # ≈ Σg² (+ feedback)
    V = cs.update(spec_v, V.add_((1.0 - b2) * G_v), uids,
                  -(1.0 - b2) * v_old)
    vhat = true_div(torch.clamp_min(v_old + (1.0 - b2) * (g2hat - v_old),
                                    0.0), bc2)
    direction = col * mhat / (torch.sqrt(vhat) + eps)
    if dir_clip is not None:
        direction = torch.clamp(direction, -dir_clip, dir_clip)
    return DpAdamResult(M=M, V=V, residual=residual, uids=uids,
                        rows=direction, mask=mask)
