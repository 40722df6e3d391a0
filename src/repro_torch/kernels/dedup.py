"""Dedup pre-pass for the batch-parallel CS-Adam step.

Counterpart of ``repro.kernels.dedup``.  Duplicate occurrences of an id
are occurrences of the same gradient row, so they are summed first; the
batch is then collision-free in id space and the whole-batch step
applies.  Every output keeps the input length ``k`` (padding past
``n_unique`` holds ``fill_id`` and zero rows), and ``n_unique`` stays a
tensor on the device, so the pass never waits for the device.

    d = dedup_rows(ids, rows)
    ... any collision-free batch step on (d.unique_ids, d.rows) ...
    upd = scatter_back(d, upd_unique)

Order of the segment sum: ``index_add_`` on the CPU adds each segment's
rows one after another in sorted order, as ``jax.ops.segment_sum`` does,
so the sums match the reference to the bit.  On CUDA, f32 rows are
summed by B5's run scatter at depth 1 over the sort itself (a slot's
rows are its run of sorted positions, added in that order from zero):
no atomics, the same bits as the CPU and the same bits from run to run.
Other dtypes on CUDA still go through ``index_add_``, whose atomics
order duplicates differently from run to run; no entry point of the port
builds such rows (its gradients are f32).  The integer outputs are exact
on every device.

``index_add_rows`` is ``table.index_add_(0, ids, rows)`` in the same
order on every device: on CUDA the same sort and run scatter, into the
touched table rows gathered into a slab rather than into zeros.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.cs_update import cs_update


class DedupBatch(NamedTuple):
    """A collision-free (in id space) view of an (ids, rows) batch."""

    unique_ids: torch.Tensor   # (k,) int32: sorted unique ids, then fill_id
    rows: torch.Tensor         # (k, d): segment-summed gradient rows
    inv: torch.Tensor          # (k,) int32: input position -> unique slot
    first_pos: torch.Tensor    # (k,) int32: unique slot -> first input
                               #   position of its id (k for padding)
    n_unique: torch.Tensor     # () int32: number of live unique slots

    @property
    def mask(self) -> torch.Tensor:
        """(k,) float32: 1 for live unique slots, 0 for padding."""
        k = self.unique_ids.shape[0]
        pos = torch.arange(k, device=self.unique_ids.device)
        return (pos < self.n_unique).to(torch.float32)


def dedup_rows(ids: torch.Tensor, rows: torch.Tensor,
               fill_id: int = -1) -> DedupBatch:
    """Sort ``ids`` stably and merge duplicates by summing their rows.

    ids: (k,) integer ids, duplicates allowed; rows: (k, d)."""
    k = ids.shape[0]
    dev = ids.device
    if k == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return DedupBatch(unique_ids=z, rows=rows, inv=z, first_pos=z,
                          n_unique=torch.zeros((), dtype=torch.int32,
                                               device=dev))
    order, seg, unique_ids, inv, n_unique = _segments(ids, fill_id)
    if dev.type == "cuda" and rows.dtype == torch.float32:
        summed = _segment_sum_runs(rows, seg, order, inv, torch.zeros(
            rows.shape, dtype=rows.dtype, device=dev))
    else:
        summed = torch.zeros_like(rows).index_add_(0, seg, rows[order])
    # stable sort: within a segment `order` ascends, so the min is the
    # id's first input position; padding slots keep the sentinel k
    first_pos = torch.full((k,), k, dtype=torch.int64, device=dev)
    first_pos.scatter_reduce_(0, seg, order, reduce="amin")
    return DedupBatch(unique_ids=unique_ids, rows=summed,
                      inv=inv.to(torch.int32),
                      first_pos=first_pos.to(torch.int32),
                      n_unique=n_unique)


def _segments(ids: torch.Tensor, fill_id: int = -1):
    """The stable sort of ``ids`` (k > 0) as segments: ``(order, seg,
    unique_ids, inv, n_unique)``, ``order`` and ``seg`` (segment of each
    sorted position) and ``inv`` (segment of each input position) int64,
    ``unique_ids`` (k,) int32 padded with ``fill_id``, ``n_unique`` a
    device scalar."""
    k, dev = ids.shape[0], ids.device
    sorted_ids, order = torch.sort(ids.to(torch.int32), stable=True)
    is_start = torch.ones((k,), dtype=torch.int64, device=dev)
    is_start[1:] = (sorted_ids[1:] != sorted_ids[:-1]).to(torch.int64)
    seg = torch.cumsum(is_start, 0) - 1                    # (k,) segment index
    n_unique = (seg[-1] + 1).to(torch.int32)
    unique_ids = torch.full((k,), fill_id, dtype=torch.int32, device=dev)
    unique_ids.scatter_(0, seg, sorted_ids)
    inv = torch.empty((k,), dtype=torch.int64, device=dev)
    inv.scatter_(0, order, seg)
    return order, seg, unique_ids, inv, n_unique


def _segment_sum_runs(rows: torch.Tensor, seg: torch.Tensor,
                      order: torch.Tensor, inv: torch.Tensor,
                      into: torch.Tensor) -> torch.Tensor:
    """Add each segment's CUDA f32 rows into its slot of ``into`` (k, ...)
    IN PLACE, in sorted order from the slot's value: B5 at depth 1, where
    slot u is a bucket whose run is the sorted positions ``starts[u] ..
    starts[u+1]`` of ``order``; B5 reads the rows in place.  ``starts``
    is found on the device (padding slots: empty runs at k)."""
    k = rows.shape[0]
    starts = torch.full((k + 1,), k, dtype=torch.int64, device=rows.device)
    starts.scatter_reduce_(0, seg, torch.arange(k, device=rows.device),
                           reduce="amin")
    cs_update(into.view(1, k, -1), inv.to(torch.int32).view(1, k), None,
              rows.reshape(k, -1).contiguous(),
              csr=(order.to(torch.int32).view(1, k),
                   starts.to(torch.int32).view(1, k + 1)))
    return into


def live_slots(unique_ids: torch.Tensor, n_unique: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, target)`` (k,) int64: each slot, padding slots replaced by
    the last live one, and the id it names.  Copying per-slot values
    ``vals[slot]`` to rows ``target`` writes each touched row once with
    its live slot's value (padding slots repeat the last live slot's
    write), with no ``n_unique`` read on the host."""
    k = unique_ids.shape[0]
    slot = torch.minimum(torch.arange(k, device=unique_ids.device),
                         n_unique.long() - 1)
    return slot, unique_ids.long()[slot]


def index_add_rows(table: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """``table.index_add_(0, ids, rows)`` IN PLACE, every occurrence of
    an id added in item order from the table's own value, ((t+u1)+u2) as
    the reference's ``table.at[ids].add(rows)`` adds.  On a CUDA f32
    table the touched rows are gathered into a (k, ...) slab, B5's run
    scatter adds each id's rows into its slot, and the slots are copied
    back: O(k·d) work, no atomics, the CPU's bits.  Padding slots hold a
    copy of the last live slot, so every copy to a row writes the same
    bits.  Elsewhere one ``index_add_``."""
    rows = rows.to(table.dtype)
    if table.device.type != "cuda" or table.dtype != torch.float32 \
            or ids.shape[0] == 0:
        return table.index_add_(0, ids.long(), rows)
    order, seg, unique_ids, inv, n_unique = _segments(ids)
    slot, target = live_slots(unique_ids, n_unique)
    slab = table[target]
    _segment_sum_runs(rows, seg, order, inv, slab)
    return table.index_copy_(0, target, slab[slot])


def scatter_back(batch: DedupBatch, unique_out: torch.Tensor) -> torch.Tensor:
    """(k, d) results over unique slots -> (k, d) results at the input
    positions: the whole result at each id's first occurrence, zeros at
    later duplicates, so ``table.index_add_(0, ids, out)`` applies each
    unique update once.  Padding slots land nowhere, whatever they hold:
    the caller need not zero them."""
    k = batch.inv.shape[0]
    # one spare row takes the padding slots' sentinel position k
    out = torch.zeros((k + 1,) + tuple(unique_out.shape[1:]),
                      dtype=unique_out.dtype, device=unique_out.device)
    out.index_copy_(0, batch.first_pos.long(), unique_out)
    return out[:k]


def gather_back(batch: DedupBatch, unique_out: torch.Tensor) -> torch.Tensor:
    """Every occurrence, duplicates included, receives its slot's row."""
    return unique_out[batch.inv.long()]


def pad_to_multiple(batch: DedupBatch, multiple: int,
                    fill_id: int = -1) -> DedupBatch:
    """Pad every slot-indexed array to a multiple of ``multiple``; the new
    slots look like dedup padding."""
    k = batch.unique_ids.shape[0]
    if multiple <= 1 or k % multiple == 0 and k > 0:
        return batch
    k_pad = max(-(-k // multiple) * multiple, multiple)
    pad = k_pad - k
    F = torch.nn.functional
    return DedupBatch(
        unique_ids=F.pad(batch.unique_ids, (0, pad), value=fill_id),
        rows=F.pad(batch.rows, (0, 0, 0, pad)),
        inv=batch.inv,
        first_pos=F.pad(batch.first_pos, (0, pad), value=k),
        n_unique=batch.n_unique)
