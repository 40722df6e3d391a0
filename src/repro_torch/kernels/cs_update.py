"""B5 · batch UPDATE: signed scatter-add of ``(k, d)`` rows, duplicate
buckets accumulating; and the stable bucket CSR that B5, B3 and B2 share.

Replaces the TPU kernel ``repro/kernels/cs_update.py::cs_update``.  As on
the TPU, the items are first grouped by bucket in each hash row, stably
(``bucket_csr``: on CUDA tensors the kernel of ``csrc/cs_csr.cu``, a
histogram, a scan and an in-order placement in shared memory; its plain
version ``bucket_csr_plain`` is a stable ``torch.sort`` and a
``searchsorted``).  Each bucket's items are then a run of sorted
positions, and the CUDA scatter (``csrc/cs_update.cu``) adds every run
into its sketch row in item order, starting from the row's old value,
and writes each touched cell once: short runs by blocks over the sorted
positions, long runs (the zipf head) by one warp per 32-column slice,
each pulling item rows through a ``cp.async`` ring.  No atomics,
deterministic, and in the order of the CPU ``index_add_``: bit-equal to
its plain version ``ref.cs_update_ref`` run on the CPU, and on the card
within rounding of that version, whose ``index_add_`` uses atomics.
Bound on the card: bytes.  The wrappers run the plain versions only for
CPU tensors; for CUDA tensors they launch the kernels or raise.

The same run scatter makes every colliding sum of the port deterministic
on the card: B1's scatter (M and V as two targets of one launch, from
``csrc/cs_adam_tiled.cu``), the dedup segment sum, ``core.sketch.update``
and ``DenseStore.accumulate`` (these three through ``cs_update``), and a
shard's slab update (``cs_update_slab``): there the buckets lie in
``[0, lw]``, ``lw`` meaning another shard's, the CSR spans ``lw + 1``
buckets and the scatter walks the first ``lw``, so the other shards' rows
are never read (no mask compaction, no scratch slab).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref


# Widths up to this keep the CSR kernel's bucket cursors in shared memory
# (csrc/cs_csr.cu, kSharedBuckets); wider ones in device scratch.
SHARED_BUCKETS = 48 * 1024


def bucket_csr_plain(buckets: torch.Tensor, width: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain form of ``bucket_csr`` and ``bucket_prev``: ``(order,
    starts, prev)``, all int32, on any device."""
    sorted_b, order = torch.sort(buckets.long(), dim=1, stable=True)
    edges = torch.arange(width + 1, device=buckets.device)
    starts = torch.searchsorted(
        sorted_b, edges.expand(buckets.shape[0], width + 1).contiguous())
    # in sorted order, the item before shares the bucket or there is none
    before = torch.full_like(order, -1)
    same = sorted_b[:, 1:] == sorted_b[:, :-1]
    before[:, 1:] = torch.where(same, order[:, :-1], -1)
    prev = torch.empty_like(order).scatter_(1, order, before)
    return (order.to(torch.int32).contiguous(),
            starts.to(torch.int32).contiguous(),
            prev.to(torch.int32).contiguous())


def _csr_kernel(buckets: torch.Tensor, width: int, with_prev: bool):
    dev = buckets.device
    if dev.type != "cuda":
        raise ValueError(f"bucket_csr: no kernel for device {dev}")
    if buckets.dim() != 2 or width < 1:
        raise ValueError(f"bucket_csr: buckets {tuple(buckets.shape)} must "
                         f"be (depth, k) and width {width} positive")
    build.check_cuda_inputs("bucket_csr", dev, buckets=buckets)
    depth, k = buckets.shape
    order = torch.empty((depth, k), dtype=torch.int32, device=dev)
    starts = torch.empty((depth, width + 1), dtype=torch.int32, device=dev)
    prev = torch.empty((depth, k), dtype=torch.int32, device=dev) \
        if with_prev else None
    scratch = torch.empty((depth, width), dtype=torch.int32, device=dev) \
        if width > SHARED_BUCKETS else None
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.bucket_csr_launch(build.ptr(buckets), build.ptr(order),
                                   build.ptr(starts), build.ptr(prev),
                                   build.ptr(scratch), depth, width, k,
                                   build.stream_handle(dev))
    build.check_launch(rc, "bucket_csr")
    bucket_csr.launches += 1
    return order, starts, prev


def bucket_csr(buckets: torch.Tensor, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The items of each hash row grouped by bucket: ``order`` (v, k)
    int32, item positions stably sorted by bucket, and ``starts`` (v,
    w+1) int32, where bucket ``b``'s items are ``order[j, starts[j, b]:
    starts[j, b+1]]``, in item order.  ``buckets`` (v, k) int32 in [0,
    width)."""
    if buckets.device.type == "cpu":
        return bucket_csr_plain(buckets, width)[:2]
    return _csr_kernel(buckets, width, False)[:2]


def bucket_prev(buckets: torch.Tensor, width: int) -> torch.Tensor:
    """For each item, the last earlier item of its hash row with the same
    bucket, or -1: (v, k) int32.  On CUDA tensors one launch of the CSR
    kernel, counted on ``bucket_csr``."""
    if buckets.device.type == "cpu":
        return bucket_csr_plain(buckets, width)[2]
    return _csr_kernel(buckets, width, True)[2]


bucket_csr.launches = 0


def scatter_shapes(name: str, S, buckets, signs, rows) -> Tuple[int, ...]:
    """(depth, width, d, k) after checking that the shapes agree."""
    depth, width, d = S.shape
    k = buckets.shape[1]
    if tuple(buckets.shape) != (depth, k) or tuple(rows.shape) != (k, d) \
            or (signs is not None and tuple(signs.shape) != (depth, k)):
        raise ValueError(f"{name}: S {tuple(S.shape)}, buckets "
                         f"{tuple(buckets.shape)}, signs and rows "
                         f"{tuple(rows.shape)} disagree")
    return depth, width, d, k


def _scatter_kernel(name: str, S, buckets, signs, delta, csr,
                    csr_width: int) -> torch.Tensor:
    """One launch of B5 into S (v, w, d) over the CSR of ``buckets`` across
    ``csr_width`` buckets (``w``, or ``w + 1`` with bucket ``w`` dropped);
    counted on ``cs_update``."""
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    depth, width, d, k = scatter_shapes(name, S, buckets, signs, delta)
    build.check_cuda_inputs(name, dev, S=S, buckets=buckets, signs=signs,
                            delta=delta)
    order, starts = csr if csr is not None \
        else bucket_csr(buckets, csr_width)
    build.check_cuda_inputs(name, dev, order=order, starts=starts)
    if tuple(starts.shape) != (depth, csr_width + 1):
        raise ValueError(f"{name}: starts {tuple(starts.shape)} is not the "
                         f"CSR of {csr_width} buckets")
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.cs_update_launch(build.ptr(S), build.ptr(order),
                                  build.ptr(starts), build.ptr(buckets),
                                  build.ptr(signs), build.ptr(delta), depth,
                                  width, csr_width, d, k,
                                  build.stream_handle(dev))
    build.check_launch(rc, name)
    cs_update.launches += 1
    return S


def cs_update(S: torch.Tensor, buckets: torch.Tensor,
              signs: Optional[torch.Tensor], delta: torch.Tensor, *,
              csr=None) -> torch.Tensor:
    """Add ``signs*delta`` (k, d) at ``buckets`` (v, k) into S (v, w, d),
    IN PLACE; returns S.  ``csr`` is ``bucket_csr(buckets, w)`` when the
    caller has it already."""
    if S.device.type == "cpu":
        return ref.cs_update_ref(S, buckets, signs, delta)
    return _scatter_kernel("cs_update", S, buckets, signs, delta, csr,
                           S.shape[1])


def cs_update_slab(slab: torch.Tensor, local: torch.Tensor,
                   signs: Optional[torch.Tensor], delta: torch.Tensor, *,
                   csr=None) -> torch.Tensor:
    """B5 in slab mode: add ``signs*delta`` (k, d) at the local buckets
    (v, k) in ``[0, lw]`` into one shard's contiguous slab (v, lw, d), IN
    PLACE, dropping bucket ``lw`` (another shard's); returns the slab.  On
    CUDA one launch (its CSR over ``lw + 1`` buckets, ``csr`` when the
    caller has it), counted on ``cs_update``; on the CPU the plain version
    ``ref.cs_update_slab_ref``."""
    if slab.device.type == "cpu":
        return ref.cs_update_slab_ref(slab, local, signs, delta)
    return _scatter_kernel("cs_update_slab", slab, local, signs, delta, csr,
                           slab.shape[1] + 1)


cs_update.launches = 0
