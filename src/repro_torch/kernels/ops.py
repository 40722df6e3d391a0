"""The backends of the port's kernel ops, counterpart of
``repro.kernels.ops``.  Sketches are updated IN PLACE.

Sparse-rows CS-Adam, ``ref | xla | stream | tiled``: each backend takes
``(spec_m, spec_v, M, V, ids, g, step)`` and returns ``(M', V',
row_updates)`` with ``row_updates`` aligned to ``ids`` such that
``table.index_add_(0, ids, row_updates)`` applies the step.

The dense path's fused ``update_read``, ``ref | xla | tiled``: each takes
``(spec, S, ids, x, beta=, scale=, mask=)`` and returns ``(S', est)``;
``ids=None`` is the whole table, ``arange(x.shape[0])``, whose addressing
is hashed once per (spec, n, device) and kept on the device.

``sketch_query``/``sketch_update``: B4/B5 for CUDA tensors, the plain
``ref`` forms for CPU tensors.  The dense path's plain routes sum through
``cs_update`` too (``_ordered_scatter``): on a card B5, in the CPU
``index_add_``'s order.

Low-precision cells (bf16, int8; ``_lowp``) follow the reference's
routes: the batch sketch ops and every sparse-rows backend run the
whole-batch ``xla`` form through ``core.sketch`` (no B1, B2, B4 or B5),
which draws a fresh rounding seed each step (``quantize.step_seed``);
the dense path's ``ref`` and ``xla`` share ``_ema_update_read_lowp``, and
``tiled`` takes bf16 into B3's bf16 kernel and int8 to ``xla``.

Scalars: the step counter is read on the host, and the learning rate and
bias corrections are float32 values held in Python floats.  The bias
correction is ``1 - f32(b**t)`` with ``b**t`` taken in float64: that
matches the reference's float32 ``1 - b**t`` more often than a float32
power does, but not always (one ulp at some steps), so float results are
held to the reference to a tolerance and integers to the bit.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import sketch as cs
from repro_torch.core.sketch import SketchSpec
from repro_torch.kernels import dedup as dd
from repro_torch.kernels import ref
from repro_torch.kernels.cs_adam import cs_adam_fused
from repro_torch.kernels.cs_adam_tiled import cs_adam_tiled
from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled, cs_ema_tiled_plain
from repro_torch.kernels.cs_query import cs_query
from repro_torch.kernels.cs_update import bucket_csr, cs_update

Result = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]


def _lowp(*specs: Optional[SketchSpec]) -> bool:
    """True when any given spec stores cells below f32 (bf16 or int8)."""
    return any(spec is not None and spec.lowp for spec in specs)


def _addressing(spec: SketchSpec, ids: torch.Tensor):
    fam = spec.family
    return fam.bucket(ids), (fam.sign(ids) if spec.signed else None)


def sketch_query(spec: SketchSpec, S, ids: torch.Tensor) -> torch.Tensor:
    """QUERY rows ``ids``: B4 for CUDA tensors, ``ref`` on the CPU;
    low-precision cells through ``core.sketch.query``."""
    if _lowp(spec):
        return cs.query(spec, S, ids)
    b, s = _addressing(spec, ids)
    return cs_query(S, b, s)


def sketch_update(spec: SketchSpec, S, ids: torch.Tensor,
                  delta: torch.Tensor, sr_seed=None):
    """UPDATE rows ``ids`` with ``delta``, IN PLACE: B5 for CUDA tensors,
    ``ref`` on the CPU; low-precision cells through ``core.sketch.update``
    (rounding seed ``sr_seed``, None: the step-0 seed)."""
    if _lowp(spec):
        return cs.update(spec, S, ids, delta, sr_seed=sr_seed)
    b, s = _addressing(spec, ids)
    return cs_update(S, b, s, delta.contiguous())


def bias_correction(b: float, t: int) -> float:
    """``1 - b**t`` as a float32 value in a Python float, the power taken
    in float64 and rounded once."""
    return float(np.float32(1.0) - np.float32(b ** t))


def _adam_hypers(step, lr, b1: float, b2: float):
    """(eta, bc1, bc2) at ``step`` as float32 values in Python floats."""
    t = int(step)
    eta = float(lr(step)) if callable(lr) else float(lr)
    return (float(np.float32(eta)), bias_correction(b1, t),
            bias_correction(b2, t))


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
    any device.  Low-precision cells run 'xla': re-rounding after every
    item would compound the rounding noise ``k`` times a step."""
    if _lowp(spec_m, spec_v):
        return adam_rows_xla(spec_m, spec_v, M, V, ids, g, step, lr=lr,
                             b1=b1, b2=b2, eps=eps)
    bm, sm, bv = _adam_addressing(spec_m, spec_v, ids)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    return ref.adam_fused_ref(M, V, bm, sm, bv, g, lr=eta, b1=b1, b2=b2,
                              eps=eps, bc1=bc1, bc2=bc2)


def adam_rows_stream(spec_m, spec_v, M, V, ids, g, step, *, lr,
                     b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> Result:
    """'stream': the per-item CUDA kernel ``cs_adam_fused`` (B2); its
    plain version on the CPU.  Low-precision cells run 'xla'."""
    if _lowp(spec_m, spec_v):
        return adam_rows_xla(spec_m, spec_v, M, V, ids, g, step, lr=lr,
                             b1=b1, b2=b2, eps=eps)
    bm, sm, bv = _adam_addressing(spec_m, spec_v, ids)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    return cs_adam_fused(M, V, bm, sm, bv, g.contiguous(), lr=eta, b1=b1,
                         b2=b2, eps=eps, bc1=bc1, bc2=bc2)


def adam_rows_xla(spec_m, spec_v, M, V, ids, g, step, *, lr,
                  b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Result:
    """'xla': the dedup pre-pass, then the vectorized whole-batch step
    through ``core.sketch`` — plain PyTorch, the CPU default.
    Low-precision cells draw a fresh rounding seed each step from the
    host step counter."""
    if ids.shape[0] == 0:
        return _empty(M, V, g)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    batch = dd.dedup_rows(ids, g)
    mask = batch.mask[:, None]
    uids, rows = batch.unique_ids, batch.rows
    sr_m = qz.step_seed(spec_m.seed, step) if _lowp(spec_m) else None
    sr_v = qz.step_seed(spec_v.seed, step) if _lowp(spec_v) else None
    if spec_m is not None:
        m_old = cs.query(spec_m, M, uids)
        dm = (1.0 - b1) * (rows - m_old) * mask
        M = cs.update(spec_m, M, uids, dm, sr_seed=sr_m)
        mhat = ref.true_div(m_old + dm, bc1)
    else:
        mhat = rows
    v_old = cs.query(spec_v, V, uids)
    dv = (1.0 - b2) * (rows * rows - v_old) * mask
    V = cs.update(spec_v, V, uids, dv, sr_seed=sr_v)
    vhat = ref.true_div(torch.clamp_min(v_old + dv, 0.0), bc2)
    upd = mask * (-eta) * mhat / (torch.sqrt(vhat) + eps)
    return M, V, dd.scatter_back(batch, upd)


def adam_rows_tiled(spec_m, spec_v, M, V, ids, g, step, *, lr,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> Result:
    """'tiled': the dedup pre-pass, then the batch-parallel CUDA kernel
    ``cs_adam_tiled`` (B1) over the unique rows; its plain version on the
    CPU.  Only each id's first occurrence carries its update: B1 writes
    it there itself (``positions``), so no ``scatter_back`` follows.  B1
    has one block per unique row, so the batch needs no padding to a
    tile.  Low-precision cells run 'xla', as in the reference: B1 holds
    f32 cells."""
    if _lowp(spec_m, spec_v):
        return adam_rows_xla(spec_m, spec_v, M, V, ids, g, step, lr=lr,
                             b1=b1, b2=b2, eps=eps)
    if ids.shape[0] == 0:
        return _empty(M, V, g)
    eta, bc1, bc2 = _adam_hypers(step, lr, b1, b2)
    batch = dd.dedup_rows(ids, g)
    bm, sm, bv = _adam_addressing(spec_m, spec_v, batch.unique_ids)
    return cs_adam_tiled(M, V, bm, sm, bv, batch.rows, lr=eta, b1=b1, b2=b2,
                         eps=eps, bc1=bc1, bc2=bc2, n_valid=batch.n_unique,
                         positions=(batch.inv, batch.first_pos))


# ---------------------------------------------------------------------------
# The dense path's fused update_read
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cached_addressing(spec: SketchSpec, n: int, device: torch.device):
    """Buckets and signs of the dense row set ``arange(n)``, hashed once
    per (spec, n, device) and kept on the device.  The caller knows the
    row set is dense (``ids is None``), so the ids are never looked at on
    the host."""
    return _addressing(spec, torch.arange(n, dtype=torch.int32,
                                          device=device))


@functools.lru_cache(maxsize=64)
def _cached_csr(spec: SketchSpec, n: int, device: torch.device):
    """``bucket_csr`` of the dense row set, for B3's scatter."""
    return bucket_csr(_cached_addressing(spec, n, device)[0], spec.width)


def _ema_addressing(spec: SketchSpec, ids: Optional[torch.Tensor], n: int,
                    device: torch.device):
    if ids is None:
        return _cached_addressing(spec, n, device)
    return _addressing(spec, ids)


def _ordered_scatter(spec: SketchSpec, ids, x: torch.Tensor):
    """The plain routes' scatter ``(S, b, s, d) -> S``: ``cs_update``,
    which adds in the CPU ``index_add_``'s order on every device (B5 on
    the card, with the dense row set's cached CSR)."""
    csr = _cached_csr(spec, x.shape[0], x.device) \
        if ids is None and x.device.type == "cuda" else None

    def scatter(S, b, s, d):
        return cs_update(S, b, s, d.contiguous(), csr=csr)
    return scatter


def _ema_update_read_lowp(spec: SketchSpec, S, ids, x, *, beta: float,
                          scale: float, mask, sr_seed):
    """The low-precision ``update_read`` shared by 'ref' and 'xla' (and
    'tiled' for int8): the dense-path write regime.  The increments are
    summed from zero in f32 and added to the dequantized sketch, and the
    whole sketch is re-rounded: bf16 in place (``cs_ema_tiled_plain``),
    int8 under fresh absmax block scales."""
    sr_seed = cs.sr_seed_or_default(spec, sr_seed)
    b, s = _ema_addressing(spec, ids, x.shape[0], x.device)
    if not spec.quantized:
        return cs_ema_tiled_plain(S, b, s, x, mask, beta=beta, scale=scale,
                                  sr_seed=sr_seed,
                                  scatter=_ordered_scatter(spec, ids, x))
    rows = cs.gather_rows(spec, S, b, s)
    est_old = cs.median_rows(rows) if spec.signed else cs.min_rows(rows)
    d = cs.ema_delta(est_old, x, beta, scale)
    if mask is not None:
        d = d * mask
    inc = _ordered_scatter(spec, ids, x)(
        torch.zeros(spec.shape, dtype=torch.float32, device=x.device),
        b, s, d)
    new = qz.quantize(qz.dequantize(S, spec.scale_block) + inc, sr_seed,
                      scale_block=spec.scale_block)
    S.cells.copy_(new.cells)
    S.scales.copy_(new.scales)
    return S, est_old + d


def ema_update_read_ref(spec: SketchSpec, S, ids, x, *, beta: float,
                        scale: float, mask=None, sr_seed=None):
    """'ref': the composed primitives one-shot: query, the shared
    ``ema_delta`` form, update.  Low-precision cells take the shared
    dense-regime form, so 'ref' and 'xla' agree at every cell dtype."""
    if _lowp(spec):
        return _ema_update_read_lowp(spec, S, ids, x, beta=beta,
                                     scale=scale, mask=mask, sr_seed=sr_seed)
    if ids is None:
        ids = torch.arange(x.shape[0], dtype=torch.int32, device=S.device)
    est_old = cs.query(spec, S, ids)
    d = cs.ema_delta(est_old, x, beta, scale)
    if mask is not None:
        d = d * mask
    S = cs.update(spec, S, ids, d)
    return S, est_old + d


def ema_update_read_xla(spec: SketchSpec, S, ids, x, *, beta: float,
                        scale: float, mask=None, sr_seed=None):
    """'xla': one gather -> ema_delta -> scatter pass in plain PyTorch,
    the addressing hashed once (cached for the dense row set); the same
    operations as 'ref', and the CPU default."""
    if _lowp(spec):
        return _ema_update_read_lowp(spec, S, ids, x, beta=beta,
                                     scale=scale, mask=mask, sr_seed=sr_seed)
    b, s = _ema_addressing(spec, ids, x.shape[0], S.device)
    return cs_ema_tiled_plain(S, b, s, x, mask, beta=beta, scale=scale,
                              scatter=_ordered_scatter(spec, ids, x))


def ema_update_read_tiled(spec: SketchSpec, S, ids, x, *, beta: float,
                          scale: float, mask=None, sr_seed=None):
    """'tiled': the CUDA kernel ``cs_ema_tiled`` (B3), with the whole-batch
    semantics of 'xla'; its plain version on the CPU.  The dense row set's
    bucket CSR is cached with its addressing.  bf16 cells run B3's bf16
    kernel with the step's rounding seed; int8 cells run 'xla', as in
    the reference (a fresh absmax scale needs the whole sketch)."""
    if spec.quantized:
        return ema_update_read_xla(spec, S, ids, x, beta=beta, scale=scale,
                                   mask=mask, sr_seed=sr_seed)
    n = x.shape[0]
    b, s = _ema_addressing(spec, ids, n, S.device)
    csr = _cached_csr(spec, n, S.device) \
        if ids is None and S.device.type == "cuda" else None
    seed = cs.sr_seed_or_default(spec, sr_seed) if spec.lowp else None
    return cs_ema_tiled(S, b, s, x.contiguous(), mask, beta=beta,
                        scale=scale, csr=csr, sr_seed=seed)
