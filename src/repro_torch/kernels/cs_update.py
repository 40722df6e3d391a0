"""B5 · batch UPDATE: signed scatter-add of ``(k, d)`` rows, duplicate
buckets accumulating.

Replaces the TPU kernel ``repro/kernels/cs_update.py::cs_update``.  As on
the TPU, the items are first sorted by bucket in each hash row, stably
(``bucket_csr``), so that the rows of one bucket lie together in item
order.  The CUDA kernel (``csrc/cs_update.cu``) then gives each thread
one (hash row, bucket, column) cell: it starts from the cell's old value
and adds ``sign*delta`` of the bucket's items one after another, in item
order.  No atomics, deterministic, and it adds in the order of the CPU
``index_add_``: bit-equal to its plain version ``ref.cs_update_ref`` run
on the CPU, and on the card within rounding of that version, whose
``index_add_`` uses atomics.  Bound on the card: bytes.  The wrapper runs
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref


def bucket_csr(buckets: torch.Tensor, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The items of each hash row grouped by bucket: ``order`` (v, k)
    int32, item positions stably sorted by bucket, and ``starts`` (v,
    w+1) int32, where bucket ``b``'s items are ``order[j, starts[j, b]:
    starts[j, b+1]]``, in item order."""
    sorted_b, order = torch.sort(buckets.long(), dim=1, stable=True)
    edges = torch.arange(width + 1, device=buckets.device)
    starts = torch.searchsorted(
        sorted_b, edges.expand(buckets.shape[0], width + 1).contiguous())
    return (order.to(torch.int32).contiguous(),
            starts.to(torch.int32).contiguous())


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


def cs_update(S: torch.Tensor, buckets: torch.Tensor,
              signs: Optional[torch.Tensor], delta: torch.Tensor, *,
              csr=None) -> torch.Tensor:
    """Add ``signs*delta`` (k, d) at ``buckets`` (v, k) into S (v, w, d),
    IN PLACE; returns S.  ``csr`` is ``bucket_csr(buckets, w)`` when the
    caller has it already."""
    if S.device.type == "cpu":
        return ref.cs_update_ref(S, buckets, signs, delta)
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"cs_update: no kernel for device {dev}")
    depth, width, d, k = scatter_shapes("cs_update", S, buckets, signs, delta)
    order, starts = csr if csr is not None else bucket_csr(buckets, width)
    build.check_cuda_inputs("cs_update", dev, S=S, signs=signs, delta=delta,
                            order=order, starts=starts)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.cs_update_launch(build.ptr(S), build.ptr(order),
                                  build.ptr(starts), build.ptr(signs),
                                  build.ptr(delta), depth, width, d, k,
                                  build.stream_handle(dev))
    build.check_launch(rc, "cs_update")
    cs_update.launches += 1
    return S


cs_update.launches = 0
