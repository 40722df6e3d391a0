"""B1 · batch-parallel CS-Adam over deduplicated rows (backend ``tiled``).

Replaces the TPU kernel ``repro/kernels/cs_adam_tiled.py::cs_adam_tiled``.
The CUDA kernels run one batch for the whole step, the semantics of the
reference's ``xla`` backend: every estimate reads the pre-step sketches
and the writes accumulate.  The TPU kernel streams across tiles of 8
rows; on a batch with no bucket collisions the two agree exactly, and
under collisions they differ by estimator noise (see
``tests/test_backends.py`` of the reference).

A call is one ``bucket_csr`` launch over the stacked M and V buckets,
then the read launch (``csrc/cs_adam_tiled.cu``: the estimates, Δm and
Δv into a scratch, the update, and the new value of every cell whose
CSR run holds one row) and one launch of B5's run scatter
(``csrc/cs_update.cu``), which adds each longer run's live rows in row
order from the old cell.  No atomics: M and V are bit-equal to the plain
version run on the CPU under any collisions, and two runs give the same
bits.  Given the dedup batch's ``positions`` (``inv``, ``first_pos``),
the read writes the update straight to the per-input-position output,
as ``dedup.scatter_back`` would place it.

``cs_adam_tiled_plain`` is the plain PyTorch version, the whole-batch form
of ``ops.adam_rows_xla`` on bucket/sign arrays.  The wrapper runs it only
for CPU tensors; for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.cs_update import bucket_csr


def cs_adam_tiled_plain(M: Optional[torch.Tensor], V: torch.Tensor,
                        bm: Optional[torch.Tensor], sm: Optional[torch.Tensor],
                        bv: torch.Tensor, g: torch.Tensor, *,
                        lr: float, b1: float, b2: float, eps: float,
                        bc1: float, bc2: float, n_valid=None
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                   torch.Tensor]:
    """Plain version of B1 on any device; updates M, V in place."""
    k = g.shape[0]
    nv = k if n_valid is None else n_valid
    valid = (torch.arange(k, device=g.device) < nv).to(torch.float32)[:, None]
    if M is not None:
        m_old = ref.cs_query_ref(M, bm, sm)
        dm = (1.0 - b1) * (g - m_old) * valid
        ref.cs_update_ref(M, bm, sm, dm)
        mhat = ref.true_div(m_old + dm, bc1)
    else:
        mhat = g
    v_old = ref.cs_query_ref(V, bv, None)
    dv = (1.0 - b2) * (g * g - v_old) * valid
    ref.cs_update_ref(V, bv, None, dv)
    v_new = torch.clamp_min(v_old + dv, 0.0)
    upd = valid * (-lr) * mhat / (torch.sqrt(ref.true_div(v_new, bc2)) + eps)
    return M, V, upd


def _f32(x: float) -> float:
    return float(np.float32(x))


def geometry(name: str, M, V, bm, sm, bv, g):
    """(k, d, depth_m, width_m, depth_v, width_v) of a CS-Adam kernel
    call, after checking that the shapes agree."""
    k, d = g.shape
    depth_v, width_v, dv_dim = V.shape
    depth_m, width_m = (M.shape[0], M.shape[1]) if M is not None else (0, 0)
    if dv_dim != d or tuple(bv.shape) != (depth_v, k):
        raise ValueError(f"{name}: V {tuple(V.shape)}, bv {tuple(bv.shape)} "
                         f"and g {tuple(g.shape)} disagree")
    if M is not None and (M.shape[2] != d
                          or tuple(bm.shape) != (depth_m, k)
                          or tuple(sm.shape) != (depth_m, k)):
        raise ValueError(f"{name}: M {tuple(M.shape)}, bm/sm and g "
                         f"{tuple(g.shape)} disagree")
    return k, d, depth_m, width_m, depth_v, width_v


def at_positions(upd: torch.Tensor, first_pos: torch.Tensor) -> torch.Tensor:
    """Slot-aligned updates (k, d) placed per input position: slot u's at
    ``first_pos[u]``, zeros elsewhere; padding slots (``first_pos`` k)
    land nowhere (``dedup.scatter_back``)."""
    k = upd.shape[0]
    out = torch.zeros((k + 1,) + tuple(upd.shape[1:]), dtype=upd.dtype,
                      device=upd.device)
    out.index_copy_(0, first_pos.long(), upd)
    return out[:k]


def cs_adam_tiled(M: Optional[torch.Tensor], V: torch.Tensor,
                  bm: Optional[torch.Tensor], sm: Optional[torch.Tensor],
                  bv: torch.Tensor, g: torch.Tensor, *,
                  lr: float, b1: float, b2: float, eps: float,
                  bc1: float, bc2: float, n_valid=None, positions=None
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """Batch-parallel CS-Adam over ``k`` deduplicated rows.

    M (dm, wm, d) f32 or None for β₁=0; V (dv, wv, d) f32; bm/sm (dm, k)
    int32/f32; bv (dv, k) int32, buckets in range (as ``HashFamily``
    makes them); g (k, d) f32.  ``n_valid`` (int or a device int32
    scalar; default k): rows at or past it are padding, add nothing and
    get zero updates.  ``positions``: the dedup batch's ``(inv,
    first_pos)``, (k,) int32 each; the update then comes back per input
    position (``dedup.scatter_back``'s layout), else per row of g.  M and
    V are updated IN PLACE.  Returns ``(M, V, upd)``."""
    if V.device.type in ref.PLAIN_DEVICES:
        M, V, upd = cs_adam_tiled_plain(M, V, bm, sm, bv, g, lr=lr, b1=b1,
                                        b2=b2, eps=eps, bc1=bc1, bc2=bc2,
                                        n_valid=n_valid)
        return M, V, (upd if positions is None
                      else at_positions(upd, positions[1]))
    dev = V.device
    if dev.type != "cuda":
        raise ValueError(f"cs_adam_tiled: no kernel for device {dev}")
    k, d, depth_m, width_m, depth_v, width_v = geometry(
        "cs_adam_tiled", M, V, bm, sm, bv, g)
    if n_valid is None or isinstance(n_valid, int):
        nv = torch.full((1,), k if n_valid is None else n_valid,
                        dtype=torch.int32, device=dev)
    else:
        nv = n_valid.reshape(1)
    inv, first_pos = positions if positions is not None else (None, None)
    if positions is not None and not (tuple(inv.shape) == (k,)
                                      == tuple(first_pos.shape)):
        raise ValueError(f"cs_adam_tiled: positions {tuple(inv.shape)}, "
                         f"{tuple(first_pos.shape)} and g {tuple(g.shape)} "
                         f"disagree")
    build.check_cuda_inputs("cs_adam_tiled", dev, M=M, V=V, bm=bm, sm=sm,
                            bv=bv, g=g, n_valid=nv, inv=inv,
                            first_pos=first_pos)
    # one CSR over the stacked buckets of both moments
    both = torch.cat([bm, bv]) if M is not None else bv
    order, starts = bucket_csr(both, max(width_m, width_v))
    upd = torch.empty((k, d), dtype=torch.float32, device=dev)
    dm = torch.empty_like(upd) if M is not None else None
    dv = torch.empty_like(upd)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.cs_adam_tiled_launch(
            build.ptr(M), build.ptr(V), build.ptr(bm), build.ptr(sm),
            build.ptr(bv), build.ptr(g), build.ptr(nv), build.ptr(inv),
            build.ptr(first_pos), build.ptr(upd), build.ptr(dm),
            build.ptr(dv), build.ptr(order), build.ptr(starts),
            build.ptr(both), depth_m, width_m, depth_v, width_v, k, d,
            _f32(lr), _f32(1.0 - b1), _f32(1.0 - b2), _f32(eps), _f32(bc1),
            _f32(bc2), build.stream_handle(dev))
    build.check_launch(rc, "cs_adam_tiled")
    cs_adam_tiled.launches += 1
    return M, V, upd


cs_adam_tiled.launches = 0
