"""B2 · streaming CS-Adam in exact per-item order (backend ``stream``).

Replaces the TPU kernel ``repro/kernels/cs_adam.py::cs_adam_fused``.  The
CUDA kernel (``csrc/cs_adam.cu``) gives each thread one column and walks
the items in order, so later items see earlier items' writes exactly as
the paper's Alg. 4 does.  It does not wait on every earlier store: the
wrapper first finds, on the device, each item's last earlier item in the
same bucket (``cs_update.bucket_prev``, one CSR launch per sketch), and
the kernel stages the addressing in shared memory, loads the cells of the
item ``WINDOW`` places ahead, and takes a cell written inside the window
from a ring of the values it wrote.  Its plain version is
``ref.adam_fused_ref``, which it matches bit for bit, duplicates and
collisions included.  The wrapper runs the plain version only for CPU
tensors; for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.cs_adam_tiled import _f32, geometry
from repro_torch.kernels.cs_update import bucket_prev

# Items between a cell's early load and its use: the kernel's kWindow
# (csrc/cs_adam.cu), for the tests that place hazards at its edges
WINDOW = 4


def cs_adam_fused(M: Optional[torch.Tensor], V: torch.Tensor,
                  bm: Optional[torch.Tensor], sm: Optional[torch.Tensor],
                  bv: torch.Tensor, g: torch.Tensor, *,
                  lr: float, b1: float, b2: float, eps: float,
                  bc1: float, bc2: float
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """Streaming CS-Adam over ``k`` items, duplicates allowed.  Same
    arguments as ``cs_adam_tiled.cs_adam_tiled`` without ``n_valid``.
    M and V are updated IN PLACE.  Returns ``(M, V, upd)``."""
    if V.device.type in ref.PLAIN_DEVICES:
        return ref.adam_fused_ref(M, V, bm, sm, bv, g, lr=lr, b1=b1, b2=b2,
                                  eps=eps, bc1=bc1, bc2=bc2)
    dev = V.device
    if dev.type != "cuda":
        raise ValueError(f"cs_adam_fused: no kernel for device {dev}")
    k, d, depth_m, width_m, depth_v, width_v = geometry(
        "cs_adam_fused", M, V, bm, sm, bv, g)
    build.check_cuda_inputs("cs_adam_fused", dev, M=M, V=V, bm=bm, sm=sm,
                            bv=bv, g=g)
    upd = torch.empty((k, d), dtype=torch.float32, device=dev)
    pm = bucket_prev(bm, width_m) if M is not None else None
    pv = bucket_prev(bv, width_v)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.cs_adam_fused_launch(
            build.ptr(M), build.ptr(V), build.ptr(bm), build.ptr(sm),
            build.ptr(bv), build.ptr(pm), build.ptr(pv), build.ptr(g),
            build.ptr(upd), depth_m, width_m, depth_v, width_v, k, d,
            _f32(lr), _f32(1.0 - b1), _f32(1.0 - b2), _f32(eps), _f32(bc1),
            _f32(bc2), build.stream_handle(dev))
    build.check_launch(rc, "cs_adam_fused")
    cs_adam_fused.launches += 1
    return M, V, upd


cs_adam_fused.launches = 0
