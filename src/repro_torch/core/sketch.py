"""The Count-Sketch tensor (paper §2, §4) on PyTorch tensors, f32 cells.

Counterpart of ``repro.core.sketch``.  State is one tensor ``S`` of shape
``(depth, width, dim)``: ``depth`` hash rows, ``width`` buckets and the
uncompressed trailing ``dim`` axis.  A signed sketch (Count-Sketch) adds
``s_j(i)·Δ`` and reads the median over depth; an unsigned one
(Count-Min) adds ``Δ`` and reads the min.

The batched step reads the pre-step sketch, then scatter-adds:

    est_old = query(S, ids);  update(S, ids, Δ);  est_new = est_old + Δ

``update`` adds into ``S`` IN PLACE and returns it.  On the CPU
``index_add_`` adds colliding rows one after another in batch order, as
XLA does, so the result is the reference's to the bit.  On CUDA it adds
them with atomics, whose order varies from run to run.

Only float32 cells are ported; bfloat16 and int8 cells raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.hashing import HashFamily

F32 = "float32"


def cell_dtype_name(dtype) -> str:
    """Canonical name of a cell dtype; only float32 is ported."""
    name = str(dtype).replace("torch.", "")
    if name != F32:
        raise NotImplementedError(
            f"sketch cells of dtype {name!r} are not ported yet (ROADMAP "
            f"A7); the port stores float32 cells only")
    return name


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static description of a sketch tensor.  ``dtype`` is a name
    ('float32') or ``torch.float32``; see ``repro.core.sketch.SketchSpec``
    for ``shards``/``layout``."""

    depth: int
    width: int
    dim: int
    signed: bool = True
    seed: int = 0
    dtype: str = F32
    identity: bool = False
    shards: int = 1
    layout: str = "width"

    def __post_init__(self):
        if self.layout not in ("width", "hash"):
            raise ValueError(f"unknown shard layout {self.layout!r} "
                             f"(expected 'width' or 'hash')")
        if self.shards < 1 or self.width % self.shards != 0:
            raise ValueError(f"sketch width {self.width} must divide into "
                             f"{self.shards} shards")
        cell_dtype_name(self.dtype)

    @property
    def family(self) -> HashFamily:
        return HashFamily(seed=self.seed, depth=self.depth, width=self.width,
                          identity=self.identity, shards=self.shards,
                          layout=self.layout)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.depth, self.width, self.dim)

    def nbytes(self) -> int:
        return self.depth * self.width * self.dim * 4


def for_param(shape: Tuple[int, ...], *, compression: float = 5.0,
              depth: int = 3, signed: bool = True, seed: int = 0,
              dtype=F32, width_multiple: int = 256,
              identity: bool = False) -> SketchSpec:
    """Spec for an (n, d) auxiliary variable compressed ``compression``×,
    width rounded up to ``width_multiple`` (same rule as the reference)."""
    if len(shape) != 2:
        raise ValueError(f"sketched params must be rank-2 (rows, dim), got {shape}")
    n, d = shape
    dtype = cell_dtype_name(dtype)
    if identity:
        w = -(-n // width_multiple) * width_multiple
        return SketchSpec(depth=depth, width=w, dim=d, signed=signed,
                          seed=seed, dtype=dtype, identity=True)
    w = max(int(n / (compression * depth)), 1)
    w = -(-w // width_multiple) * width_multiple
    w = min(w, max(n, width_multiple))
    return SketchSpec(depth=depth, width=w, dim=d, signed=signed, seed=seed,
                      dtype=dtype, identity=identity)


def init(spec: SketchSpec, device="cuda") -> torch.Tensor:
    """Zero state on ``device``."""
    return torch.zeros(spec.shape, dtype=torch.float32, device=device)


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


def query(spec: SketchSpec, S: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """QUERY (paper Alg. 1): estimates of rows ``ids`` -> (k, dim)."""
    fam = spec.family
    b = fam.bucket(ids).long()                       # (depth, k)
    rows = [S[j].index_select(0, b[j]) for j in range(spec.depth)]
    if spec.signed:
        s = fam.sign(ids)
        return median_rows([r * s[j][:, None] for j, r in enumerate(rows)])
    return min_rows(rows)


def update(spec: SketchSpec, S: torch.Tensor, ids: torch.Tensor,
           delta: torch.Tensor) -> torch.Tensor:
    """UPDATE (paper Alg. 1): add ``delta`` (k, dim) at rows ``ids``,
    IN PLACE; colliding ids accumulate.  Returns ``S``."""
    fam = spec.family
    b = fam.bucket(ids).long()
    s = fam.sign(ids) if spec.signed else None
    delta = delta.to(S.dtype)
    for j in range(spec.depth):
        u = s[j][:, None] * delta if spec.signed else delta
        S[j].index_add_(0, b[j], u)
    return S


def update_and_query(spec: SketchSpec, S: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor):
    """Canonical batched step: ``(S', est_old + delta)``, ``S`` updated in
    place."""
    est_old = query(spec, S, ids)
    S = update(spec, S, ids, delta)
    return S, est_old + delta


def decay(S: torch.Tensor, alpha: float) -> torch.Tensor:
    """Cleaning heuristic (paper §4): multiply ``S`` by ``alpha`` IN
    PLACE."""
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
