"""The Count-Sketch tensor (paper §2, §4) on PyTorch tensors.

Counterpart of ``repro.core.sketch``.  State is one tensor ``S`` of shape
``(depth, width, dim)``: ``depth`` hash rows, ``width`` buckets and the
uncompressed trailing ``dim`` axis.  A signed sketch (Count-Sketch) adds
``s_j(i)·Δ`` and reads the median over depth; an unsigned one
(Count-Min) adds ``Δ`` and reads the min.

The batched step reads the pre-step sketch, then scatter-adds:

    est_old = query(S, ids);  update(S, ids, Δ);  est_new = est_old + Δ

``update`` writes ``S`` IN PLACE and returns it.  On the CPU
``index_add_`` adds colliding rows one after another in batch order, as
XLA does, so the result is the reference's to the bit.  On CUDA the sums
go through B5's run scatter (``kernels/cs_update.py``), which adds each
bucket's rows in the same batch order, with no atomics: the CPU's bits,
run after run, at every cell dtype (f32 cells directly, bf16 increments
summed from zero, int8 into the dequantized sketch).

Cells are float32, bfloat16 or int8 (``core.quantize``).  Low-precision
cells are read in f32 (bf16 widened, int8 times its block's scale, an
unsigned int8 read floored at half a scale step) and written through
stochastic rounding keyed by ``sr_seed``, the per-step seed of
``quantize.step_seed``: bf16 sums the increments from zero in f32, adds
them to the widened sketch and re-rounds every cell (a representable
value rounds to itself); int8 adds into the dequantized sketch, grows
the block scales (they never shrink between cleanings) and re-rounds the
touched and regrown blocks only.  An int8 state is a ``QuantState``,
whose two tensors are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.hashing import HashFamily
from repro_torch.core.quantize import QuantState

F32 = "float32"


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static description of a sketch tensor.  ``dtype`` is a cell dtype
    name ('float32' | 'bfloat16' | 'int8') or its ``torch.dtype``;
    ``scale_block`` is the buckets per f32 scale of int8 cells.  See
    ``repro.core.sketch.SketchSpec`` for ``shards``/``layout``."""

    depth: int
    width: int
    dim: int
    signed: bool = True
    seed: int = 0
    dtype: str = F32
    identity: bool = False
    shards: int = 1
    layout: str = "width"
    scale_block: int = qz.SCALE_BLOCK

    def __post_init__(self):
        if self.layout not in ("width", "hash"):
            raise ValueError(f"unknown shard layout {self.layout!r} "
                             f"(expected 'width' or 'hash')")
        if self.shards < 1 or self.width % self.shards != 0:
            raise ValueError(f"sketch width {self.width} must divide into "
                             f"{self.shards} shards")
        qz.cell_dtype_name(self.dtype)
        if self.quantized and self.shards > 1:
            raise ValueError("int8 sketch cells do not compose with "
                             "model-parallel sharding: a width slab would "
                             "split scale blocks; use bfloat16 or float32 "
                             "cells, or shards=1")
        if self.scale_block < 1:
            raise ValueError(f"scale_block must be >= 1, "
                             f"got {self.scale_block}")

    @property
    def cell_dtype_name(self) -> str:
        return qz.cell_dtype_name(self.dtype)

    @property
    def quantized(self) -> bool:
        """True when cells are int8 (the state is a ``QuantState``)."""
        return self.cell_dtype_name == "int8"

    @property
    def lowp(self) -> bool:
        """True when cells are stored below f32 (bf16 or int8)."""
        return self.cell_dtype_name != F32

    @property
    def family(self) -> HashFamily:
        return HashFamily(seed=self.seed, depth=self.depth, width=self.width,
                          identity=self.identity, shards=self.shards,
                          layout=self.layout)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.depth, self.width, self.dim)

    def nbytes(self) -> int:
        """Bytes of ``init(self)``: the cells at their dtype's size, plus
        the f32 block scales of int8 cells."""
        cells = self.depth * self.width * self.dim \
            * qz.torch_dtype(self.dtype).itemsize
        if self.quantized:
            return cells + self.depth * qz.n_blocks(self.width,
                                                    self.scale_block) * 4
        return cells


def for_param(shape: Tuple[int, ...], *, compression: float = 5.0,
              depth: int = 3, signed: bool = True, seed: int = 0,
              dtype=F32, width_multiple: int = 256,
              identity: bool = False) -> SketchSpec:
    """Spec for an (n, d) auxiliary variable compressed ``compression``×,
    width rounded up to ``width_multiple`` (same rule as the reference)."""
    if len(shape) != 2:
        raise ValueError(f"sketched params must be rank-2 (rows, dim), got {shape}")
    n, d = shape
    dtype = qz.cell_dtype_name(dtype)
    if identity:
        w = -(-n // width_multiple) * width_multiple
        return SketchSpec(depth=depth, width=w, dim=d, signed=signed,
                          seed=seed, dtype=dtype, identity=True)
    w = max(int(n / (compression * depth)), 1)
    w = -(-w // width_multiple) * width_multiple
    w = min(w, max(n, width_multiple))
    return SketchSpec(depth=depth, width=w, dim=d, signed=signed, seed=seed,
                      dtype=dtype, identity=identity)


def init(spec: SketchSpec, device="cuda"):
    """Zero state on ``device``: a tensor of the cell dtype, or a
    ``QuantState`` (int8 cells, f32 block scales) for int8 cells."""
    if spec.quantized:
        return QuantState(
            cells=torch.zeros(spec.shape, dtype=torch.int8, device=device),
            scales=torch.zeros((spec.depth, qz.n_blocks(spec.width,
                                                        spec.scale_block)),
                               dtype=torch.float32, device=device))
    return torch.zeros(spec.shape, dtype=qz.torch_dtype(spec.dtype),
                       device=device)


def clone(S):
    """A copy of a sketch state (tensor or ``QuantState``)."""
    if isinstance(S, QuantState):
        return QuantState(S.cells.clone(), S.scales.clone())
    return S.clone()


def device_of(S) -> torch.device:
    """The device of a sketch state (tensor or ``QuantState``)."""
    return S.cells.device if isinstance(S, QuantState) else S.device


def sr_seed_or_default(spec: SketchSpec, sr_seed) -> int:
    """The caller's per-step rounding seed, else the spec's step-0 one."""
    return sr_seed if sr_seed is not None else qz.step_seed(spec.seed)


def median_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    """Median over a list of per-depth rows.  Depth 3 uses the exact
    ``a+b+c-max-min`` form of the reference; other odd depths take the
    middle of a sort, even depths the mean of the two middles."""
    if len(rows) == 1:
        return rows[0]
    if len(rows) == 3:
        hi = torch.maximum(torch.maximum(rows[0], rows[1]), rows[2])
        lo = torch.minimum(torch.minimum(rows[0], rows[1]), rows[2])
        return rows[0] + rows[1] + rows[2] - hi - lo
    s = torch.sort(torch.stack(rows), dim=0).values
    mid = len(rows) // 2
    if len(rows) % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


def min_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    out = rows[0]
    for r in rows[1:]:
        out = torch.minimum(out, r)
    return out


def gather_rows(spec: SketchSpec, S, b: torch.Tensor,
                s=None) -> List[torch.Tensor]:
    """Per hash row, the (k, dim) f32 rows at buckets ``b`` (depth, k),
    times the signs ``s`` (depth, k) when given.  Low-precision cells are
    read in f32: bf16 widened, int8 times its block's scale, and an
    unsigned int8 read floored at half a scale step (a cell resolves
    values only to ±scale/2, and an Adam denominator built on a lower
    read would collapse); never-written blocks keep scale 0 and read
    exact zeros."""
    b = b.long()
    sc = qz.bucket_scales(S.scales, b, spec.scale_block) \
        if spec.quantized else None
    rows = []
    for j in range(spec.depth):
        if spec.quantized:
            r = S.cells[j].index_select(0, b[j]).to(torch.float32) \
                * sc[j][:, None]
            if not spec.signed:
                r = torch.maximum(r, 0.5 * sc[j][:, None])
        else:
            r = S[j].index_select(0, b[j]).to(torch.float32)
        rows.append(r if s is None else r * s[j][:, None])
    return rows


def query(spec: SketchSpec, S, ids: torch.Tensor) -> torch.Tensor:
    """QUERY (paper Alg. 1): f32 estimates of rows ``ids`` -> (k, dim)."""
    fam = spec.family
    if spec.signed:
        return median_rows(gather_rows(spec, S, fam.bucket(ids),
                                       fam.sign(ids)))
    return min_rows(gather_rows(spec, S, fam.bucket(ids)))


def _signed_rows(spec: SketchSpec, ids: torch.Tensor, delta: torch.Tensor,
                 dtype) -> List[torch.Tensor]:
    """Per hash row, the rows the update adds: ``s_j·delta`` or ``delta``."""
    delta = delta.to(dtype)
    if not spec.signed:
        return [delta] * spec.depth
    s = spec.family.sign(ids).to(dtype)
    return [s[j][:, None] * delta for j in range(spec.depth)]


def _add_rows(spec: SketchSpec, acc: torch.Tensor, ids: torch.Tensor,
              b: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Add ``s_j·delta`` (or ``delta``) at buckets ``b`` into the f32
    tensor ``acc`` (depth, width, dim), IN PLACE, in batch order: row by
    row with ``index_add_`` on the CPU, B5's run scatter on CUDA."""
    if acc.device.type == "cuda":
        from repro_torch.kernels.cs_update import cs_update
        signs = spec.family.sign(ids) if spec.signed else None
        return cs_update(acc, b, signs,
                         delta.to(torch.float32).contiguous())
    upd = _signed_rows(spec, ids, delta, torch.float32)
    bl = b.long()
    for j in range(spec.depth):
        acc[j].index_add_(0, bl[j], upd[j])
    return acc


def _update_quant(spec: SketchSpec, S: QuantState, ids: torch.Tensor,
                  b: torch.Tensor, delta: torch.Tensor,
                  sr_seed: int) -> QuantState:
    """int8 UPDATE, in place: dequantize, add in f32, grow the block
    scales, re-round the touched buckets and every bucket of a block whose
    scale grew; the other cells keep their exact int8 values."""
    w = spec.width
    new = _add_rows(spec, qz.dequantize(S, spec.scale_block), ids, b, delta)
    touched = torch.zeros((spec.depth, w), dtype=torch.bool, device=b.device)
    bl = b.long()
    for j in range(spec.depth):
        touched[j, bl[j]] = True
    scales = qz.grown_scales(S.scales, new, spec.scale_block)
    grew = qz.expand_scales(scales > S.scales, w, spec.scale_block)
    need = (touched | grew)[:, :, None]
    q = qz.quantize(new, sr_seed, scale_block=spec.scale_block,
                    scales=scales).cells
    S.cells.copy_(torch.where(need, q, S.cells))
    S.scales.copy_(scales)
    return S


def update(spec: SketchSpec, S, ids: torch.Tensor, delta: torch.Tensor,
           sr_seed=None):
    """UPDATE (paper Alg. 1): add ``delta`` (k, dim) at rows ``ids``,
    IN PLACE; colliding ids accumulate.  Low-precision writes round
    stochastically with ``sr_seed`` (None: the step-0 seed).  Returns
    ``S``."""
    b = spec.family.bucket(ids)
    if spec.quantized:
        return _update_quant(spec, S, ids, b, delta,
                             sr_seed_or_default(spec, sr_seed))
    if spec.lowp:
        inc = _add_rows(spec, torch.zeros(spec.shape, dtype=torch.float32,
                                          device=S.device), ids, b, delta)
        bits = qz.cell_bits(sr_seed_or_default(spec, sr_seed),
                            qz._lin_index(spec.shape, device=S.device))
        return S.copy_(qz.sr_bfloat16(S.to(torch.float32) + inc, bits))
    return _add_rows(spec, S, ids, b, delta)


def update_and_query(spec: SketchSpec, S, ids: torch.Tensor,
                     delta: torch.Tensor, sr_seed=None):
    """Canonical batched step: ``(S', est_old + delta)``, ``S`` updated in
    place."""
    est_old = query(spec, S, ids)
    S = update(spec, S, ids, delta, sr_seed=sr_seed)
    return S, est_old + delta


def query_after_update(spec: SketchSpec, S, ids: torch.Tensor,
                       delta: torch.Tensor, sr_seed=None):
    """Strict paper semantics (3 sketch passes): update, then query."""
    S = update(spec, S, ids, delta, sr_seed=sr_seed)
    return S, query(spec, S, ids)


def query_dense(spec: SketchSpec, S, n: int) -> torch.Tensor:
    """QUERY every row ``0 .. n-1``: (n, dim) f32."""
    return query(spec, S, torch.arange(n, dtype=torch.int32,
                                       device=device_of(S)))


def update_dense(spec: SketchSpec, S, delta: torch.Tensor, sr_seed=None):
    """UPDATE rows ``0 .. n-1`` with ``delta`` (n, dim), IN PLACE."""
    ids = torch.arange(delta.shape[0], dtype=torch.int32,
                       device=delta.device)
    return update(spec, S, ids, delta, sr_seed=sr_seed)


def update_and_query_dense(spec: SketchSpec, S, delta: torch.Tensor,
                           sr_seed=None):
    """``update_and_query`` over rows ``0 .. n-1``: ``(S', est)``."""
    ids = torch.arange(delta.shape[0], dtype=torch.int32,
                       device=delta.device)
    return update_and_query(spec, S, ids, delta, sr_seed=sr_seed)


def decay(S, alpha: float):
    """Cleaning heuristic (paper §4): multiply the sketch by ``alpha`` IN
    PLACE.  int8 folds ``alpha`` into the block scales and touches no
    cell; bf16 multiplies by ``alpha`` rounded to bf16, as the reference
    does."""
    if isinstance(S, QuantState):
        S.scales.mul_(alpha)
        return S
    if S.dtype == torch.bfloat16:
        return S.mul_(float(torch.tensor(alpha, dtype=torch.bfloat16)))
    return S.mul_(alpha)


def ema_delta(est_old: torch.Tensor, x: torch.Tensor, beta: float,
              scale: float) -> torch.Tensor:
    """The Δ moving a row from ``est_old`` to ``β·est_old + scale·x``, in
    the three pinned forms of the reference (Adam moments, Adagrad,
    momentum), which round differently."""
    sx = x if scale == 1.0 else scale * x
    if scale == 1.0 - beta:
        return scale * (x - est_old)
    if beta == 1.0:
        return sx
    return (beta - 1.0) * est_old + sx
