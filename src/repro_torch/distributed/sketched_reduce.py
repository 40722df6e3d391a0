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

``sharded_adam_rows`` is the same step with the sketch state SHARDED
into width slabs over a ``shard_axis`` (``ReplicaMesh.axis("model")``,
or a ``ProcessGroupAxis``): each replica holds one shard's (depth,
local_width, dim) slab of M, V and the residual, sketches its rows into
slabs, and one routing psum over the shard axis assembles the cells its
queries need (``sharded_query``).  Every slab write on a card is B5 in
slab mode.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import quantize as qz
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


def sharded_reduce_bytes(*specs: Optional[cs.SketchSpec]) -> int:
    """Bytes the sharded gradient-sketch psum moves per device: one slab
    per live sketch, ``1/shards`` of the replicated payload."""
    return sum(s.shard_nbytes() for s in specs if s is not None)


def routing_bytes(n_rows: int, *specs: Optional[cs.SketchSpec]) -> int:
    """Bytes of the shard-axis routing psum per device and step: each live
    sketch's (depth, n_rows, dim) query cells, once per query group."""
    return sum(s.depth * n_rows * s.dim * qz.torch_dtype(s.dtype).itemsize
               for s in specs if s is not None)


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


# ---------------------------------------------------------------------------
# Model-parallel sketches: the sharded-slab step
# ---------------------------------------------------------------------------

def sharded_query(spec: cs.SketchSpec, slab: torch.Tensor, ids: torch.Tensor,
                  shard_axis, *, backend: Optional[str] = None
                  ) -> torch.Tensor:
    """``cs.query`` against a width-sharded sketch: each shard gathers its
    slab's cells (``gather_slab``), a psum over ``shard_axis`` assembles
    them (each cell lives on one shard) and ``finish_query`` applies the
    signs and the median or min."""
    axis = as_axis(shard_axis)
    part = kernels.gather_slab(spec, slab, ids, axis.rank, backend=backend)
    with scope("obs.route"):
        part = axis.psum(part)
    return cs.finish_query(spec, part, ids)


def sharded_adam_rows(spec_m: Optional[cs.SketchSpec], spec_v: cs.SketchSpec,
                      M: Optional[torch.Tensor], V: torch.Tensor,
                      ids: torch.Tensor, rows: torch.Tensor, step, *,
                      shard_axis, dp_axis=None,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      residual: Optional[torch.Tensor] = None,
                      fill_id: Optional[int] = None,
                      dir_clip: Optional[float] = 10.0,
                      backend: Optional[str] = None) -> DpAdamResult:
    """``dp_adam_rows`` with the sketch state sharded over ``shard_axis``:
    ``M``, ``V`` and ``residual`` are this replica's (depth, local_width,
    dim) slabs, updated IN PLACE, and the specs carry ``shards`` and
    ``layout``.  Every replica of a (dp × shard) grid calls it with its
    dp shard of the batch (the same batch across ``shard_axis``) and its
    own copy of the table; ``dp_axis`` None is the shard-only grid.

    The collectives: the gradient-sketch psum over ``dp_axis`` moves one
    slab a sketch (``sharded_reduce_bytes``); one routing psum over
    ``shard_axis`` assembles the stacked query groups' (depth, k, dim)
    cells (``routing_bytes``); the id all-gather over ``dp_axis`` is the
    DP step's.  Slab updates concatenate to the full-width update and
    assembled queries equal full-width ones, so the step equals
    ``dp_adam_rows`` at the same dp, to the bit under the dyadic
    protocol.  The shard index is ``shard_axis.rank``."""
    sh_axis = as_axis(shard_axis)
    dp = as_axis(dp_axis)
    shard = sh_axis.rank
    track_m = spec_m is not None
    # replace(), not a field list: the g sketch must hash as spec_v does
    spec_g = spec_m if track_m else dataclasses.replace(spec_v, signed=True)
    if fill_id is None:
        fill_id = FILL_ID
    t = int(step)
    bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
    dev = rows.device

    def slab_update(spec, slab, at, delta):
        return kernels.update_slab(spec, slab, at, delta, shard,
                                   backend=backend)

    def slab_gather(spec, slab, at):
        return kernels.gather_slab(spec, slab, at, shard, backend=backend)

    # 1. local dedup, as in the replicated step
    batch = dd.dedup_rows(ids, rows, fill_id=fill_id)
    lids, lrows = batch.unique_ids, batch.rows

    # 2. the gradient sketches as slabs, psum'd over dp: slab bytes
    G_g = slab_update(spec_g, cs.init_slab(spec_g, dev), lids, lrows)
    G_v = slab_update(spec_v, cs.init_slab(spec_v, dev), lids,
                      torch.square(lrows))
    if dp is not None:
        with scope("obs.collective"):
            G_g, G_v = dp.psum(G_g), dp.psum(G_v)

    # the error feedback on slabs: the cross share needs Σg at the local
    # ids (one routing query); banking and injection are per bucket
    if residual is not None:
        g_sum = sharded_query(spec_g, G_g, lids, sh_axis, backend=backend)
        cross = torch.maximum(lrows * (g_sum - lrows), -torch.square(lrows))
        G_c = slab_update(spec_v, cs.init_slab(spec_v, dev), lids, cross)
        if dp is not None:
            with scope("obs.collective"):
                G_c = dp.psum(G_c)
        G_v, residual = _inject_feedback(G_v, residual, G_c)

    # 3. the global touched set (dp only; shard-only keeps the local set)
    if dp is not None:
        uids, mask = global_unique_ids(lids, dp, fill_id=fill_id)
    else:
        uids, mask = lids, (lids != fill_id).to(torch.float32)
    col = mask[:, None]

    # 4. the state update: the query groups share one routing psum; the
    #    scatters are shard-local.  Every read precedes the in-place
    #    writes of M and V.
    parts = [slab_gather(spec_g, G_g, uids), slab_gather(spec_v, V, uids),
             slab_gather(spec_v, G_v, uids)]
    if track_m:
        parts.append(slab_gather(spec_m, M, uids))
    stacked = torch.stack(parts)
    del parts                   # the psum's copy is the one that stays
    with scope("obs.route"):
        parts = sh_axis.psum(stacked).unbind(0)
    del stacked
    ghat = cs.finish_query(spec_g, parts[0], uids) * col
    v_old = cs.finish_query(spec_v, parts[1], uids) * col
    g2hat = cs.finish_query(spec_v, parts[2], uids) * col
    if track_m:
        m_old = cs.finish_query(spec_m, parts[3], uids) * col
        M = slab_update(spec_m, M.add_((1.0 - b1) * G_g), uids,
                        -(1.0 - b1) * m_old)
        mhat = true_div(m_old + (1.0 - b1) * (ghat - m_old), bc1)
    else:
        mhat = ghat
    V = slab_update(spec_v, V.add_((1.0 - b2) * G_v), uids,
                    -(1.0 - b2) * v_old)
    vhat = true_div(torch.clamp_min(v_old + (1.0 - b2) * (g2hat - v_old),
                                    0.0), bc2)
    direction = col * mhat / (torch.sqrt(vhat) + eps)
    if dir_clip is not None:
        direction = torch.clamp(direction, -dir_clip, dir_clip)
    return DpAdamResult(M=M, V=V, residual=residual, uids=uids,
                        rows=direction, mask=mask)
