"""B4 · batch QUERY: gather ``depth`` bucket rows per item and reduce.

Replaces the TPU kernel ``repro/kernels/cs_query.py::cs_query``.  The CUDA
kernel (``csrc/cs_query.cu``) gives each thread one (item, column): it
gathers the item's ``depth`` cells, multiplies by the signs and takes the
median (``a+b+c-max-min`` at depth 3, a sort at other depths, the mean of
the two middles at even depths) or, unsigned, the min.  It only gathers,
so it is bit-equal to its plain version, ``ref.cs_query_ref``.  Bound on
the card: bytes (each output cell reads ``depth`` sketch cells).  The
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref


def cs_query(S: torch.Tensor, buckets: torch.Tensor,
             signs: Optional[torch.Tensor]) -> torch.Tensor:
    """S (v, w, d) f32; buckets (v, k) int32 in range; signs (v, k) f32 or
    None (Count-Min).  Returns the (k, d) estimates."""
    if S.device.type == "cpu":
        return ref.cs_query_ref(S, buckets, signs)
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"cs_query: no kernel for device {dev}")
    depth, width, d = S.shape
    k = buckets.shape[1]
    if tuple(buckets.shape) != (depth, k) or (
            signs is not None and tuple(signs.shape) != (depth, k)):
        raise ValueError(f"cs_query: S {tuple(S.shape)}, buckets "
                         f"{tuple(buckets.shape)} and signs disagree")
    build.check_cuda_inputs("cs_query", dev, S=S, buckets=buckets,
                            signs=signs)
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.cs_query_launch(build.ptr(S), build.ptr(buckets),
                                 build.ptr(signs), build.ptr(out), depth,
                                 width, d, k, build.stream_handle(dev))
    build.check_launch(rc, "cs_query")
    cs_query.launches += 1
    return out


cs_query.launches = 0
