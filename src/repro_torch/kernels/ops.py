"""The sparse-rows CS-Adam backends: ``ref | xla | stream | tiled``.

Counterpart of the sparse-rows half of ``repro.kernels.ops``.  Each
backend takes ``(spec_m, spec_v, M, V, ids, g, step)`` and returns
``(M', V', row_updates)`` with ``row_updates`` aligned to ``ids`` such
that ``table.index_add_(0, ids, row_updates)`` applies the step.  The
sketches are updated IN PLACE.

Scalars: the step counter is read on the host, and the learning rate and
bias corrections are float32 values held in Python floats.  The bias
correction is ``1 - f32(b**t)`` with ``b**t`` taken in float64: that
matches the reference's float32 ``1 - b**t`` more often than a float32
power does, but not always (one ulp at some steps), so float results are
held to the reference to a tolerance and integers to the bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as cs
from repro_torch.core.sketch import SketchSpec
from repro_torch.kernels import dedup as dd
from repro_torch.kernels import ref
from repro_torch.kernels.cs_adam import cs_adam_fused
from repro_torch.kernels.cs_adam_tiled import cs_adam_tiled

Result = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]


def _addressing(spec: SketchSpec, ids: torch.Tensor):
    fam = spec.family
    return fam.bucket(ids), (fam.sign(ids) if spec.signed else None)


def _adam_hypers(step, lr, b1: float, b2: float):
    """(eta, bc1, bc2) at ``step`` as float32 values in Python floats."""
    t = int(step)
    eta = float(lr(step)) if callable(lr) else float(lr)
    one = np.float32(1.0)
    return (float(np.float32(eta)), float(one - np.float32(b1 ** t)),
            float(one - np.float32(b2 ** t)))


def _adam_addressing(spec_m: Optional[SketchSpec], spec_v: SketchSpec,
                     ids: torch.Tensor):
    bm, sm = _addressing(spec_m, ids) if spec_m is not None else (None, None)
    bv, _ = _addressing(spec_v, ids)
    return bm, sm, bv


def _empty(M, V, g) -> Result:
    return M, V, torch.zeros(g.shape, dtype=torch.float32, device=g.device)


def adam_rows_ref(spec_m, spec_v, M, V, ids, g, step, *, lr,
                  b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Result:
    """'ref': the per-item loop ``ref.adam_fused_ref`` (paper Alg. 4) on
    any device."""
    bm, sm, bv = _adam_addressing(spec_m, spec_v, ids)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    return ref.adam_fused_ref(M, V, bm, sm, bv, g, lr=eta, b1=b1, b2=b2,
                              eps=eps, bc1=bc1, bc2=bc2)


def adam_rows_stream(spec_m, spec_v, M, V, ids, g, step, *, lr,
                     b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> Result:
    """'stream': the per-item CUDA kernel ``cs_adam_fused`` (B2); its
    plain version on the CPU."""
    bm, sm, bv = _adam_addressing(spec_m, spec_v, ids)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    return cs_adam_fused(M, V, bm, sm, bv, g.contiguous(), lr=eta, b1=b1,
                         b2=b2, eps=eps, bc1=bc1, bc2=bc2)


def adam_rows_xla(spec_m, spec_v, M, V, ids, g, step, *, lr,
                  b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Result:
    """'xla': the dedup pre-pass, then the vectorized whole-batch step
    through ``core.sketch`` — plain PyTorch, the CPU default."""
    if ids.shape[0] == 0:
        return _empty(M, V, g)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    batch = dd.dedup_rows(ids, g)
    mask = batch.mask[:, None]
    uids, rows = batch.unique_ids, batch.rows
    if spec_m is not None:
        m_old = cs.query(spec_m, M, uids)
        dm = (1.0 - b1) * (rows - m_old) * mask
        M = cs.update(spec_m, M, uids, dm)
        mhat = ref.true_div(m_old + dm, bc1)
    else:
        mhat = rows
    v_old = cs.query(spec_v, V, uids)
    dv = (1.0 - b2) * (rows * rows - v_old) * mask
    V = cs.update(spec_v, V, uids, dv)
    vhat = ref.true_div(torch.clamp_min(v_old + dv, 0.0), bc2)
    upd = mask * (-eta) * mhat / (torch.sqrt(vhat) + eps)
    return M, V, dd.scatter_back(batch, upd)


def adam_rows_tiled(spec_m, spec_v, M, V, ids, g, step, *, lr,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> Result:
    """'tiled': the dedup pre-pass, then the batch-parallel CUDA kernel
    ``cs_adam_tiled`` (B1) over the unique rows; its plain version on the
    CPU.  Only each id's first occurrence carries its update.  B1 has one
    grid row per input row, so the batch needs no padding to a tile."""
    if ids.shape[0] == 0:
        return _empty(M, V, g)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    batch = dd.dedup_rows(ids, g)
    bm, sm, bv = _adam_addressing(spec_m, spec_v, batch.unique_ids)
    M, V, upd_u = cs_adam_tiled(M, V, bm, sm, bv, batch.rows, lr=eta, b1=b1,
                                b2=b2, eps=eps, bc1=bc1, bc2=bc2,
                                n_valid=batch.n_unique)
    return M, V, dd.scatter_back(batch, upd_u)
