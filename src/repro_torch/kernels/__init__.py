"""Hopper kernels and the backends of the port's kernel ops.

  cs_adam_tiled.py — B1, batch-parallel CS-Adam over deduplicated rows
                     (CUDA, ``csrc/cs_adam_tiled.cu``)
  cs_adam.py       — B2, streaming CS-Adam in exact per-item order
                     (CUDA, ``csrc/cs_adam.cu``)
  cs_ema_tiled.py  — B3, one moment's fused update_read, the dense path
                     (CUDA, ``csrc/cs_ema_tiled.cu``)
  cs_query.py      — B4, batch QUERY (CUDA, ``csrc/cs_query.cu``)
  cs_update.py     — B5, batch UPDATE (CUDA, ``csrc/cs_update.cu``)
  ssd.py           — B14, the Mamba2 SSD's chunked scan forward and
                     backward (CUDA, ``csrc/ssd.cuh``)
  build.py         — nvcc build at first use, ctypes loading
  dedup.py         — sort + segment-sum pre-pass
  ops.py           — the backends; ref.py — plain PyTorch forms
  registry.py      — the port's (store kind, op) -> {backend: fn} table

('pair', 'adam_rows') backends:

  ref     per-item loop (paper Alg. 4), plain PyTorch on any device
  xla     dedup + the vectorized whole-batch step, plain PyTorch; the
          ``auto`` choice for CPU tensors
  stream  B2 on CUDA tensors (exact per-item order); plain on the CPU
  tiled   dedup + B1 on CUDA tensors, whole-batch semantics; plain on the
          CPU; the ``auto`` choice for CUDA tensors

('sketch' | 'countmin', 'update_read') backends, the dense path:

  ref     query -> ema_delta -> update, plain PyTorch on any device
  xla     one gather/delta/scatter pass, addressing hashed once; the
          ``auto`` choice for CPU tensors
  tiled   B3 on CUDA tensors, whole-batch semantics; plain on the CPU;
          the ``auto`` choice for CUDA tensors

('sketch' | 'countmin', 'update_slab' | 'gather_slab') backends, the
shard-local halves of the sharded step:

  ref     ``core.sketch.update_slab`` / ``gather_slab``: the scatter is
          B5 in slab mode on CUDA tensors, plain on the CPU; the gather
          is plain everywhere
  xla     the same functions (the reference's 'xla' unrolls its vmapped
          'ref'); ``None``, ``auto`` and backends with no slab op
          resolve here

Low-precision cells: bf16 and int8 sparse rows run ``xla`` under every
backend; on the dense path ``ref`` and ``xla`` share one form, ``tiled``
runs B3's bf16 kernel for bf16 cells and ``xla`` for int8 cells.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from repro_torch.core import sketch as cs
from repro_torch.kernels import ops, registry


def register_backend(name: str, fn: Callable) -> None:
    """Register (or override) a ('pair', 'adam_rows') backend."""
    registry.register("pair", "adam_rows", name, fn)


def backends() -> Tuple[str, ...]:
    return registry.backends("pair", "adam_rows")


def resolve_backend(name: Optional[str] = None, device=None) -> str:
    """Map None/'auto' to the best backend for tensors on ``device``;
    validate names."""
    return registry.resolve("pair", "adam_rows", name, device)


def adam_rows(spec_m, spec_v, M, V, ids, g, step, *,
              lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              backend: Optional[str] = None):
    """Sparse-rows CS-Adam through the named backend (None/'auto' = best
    for ``g``'s device).  Returns ``(M', V', row_updates)``, the sketches
    updated in place; ``table.index_add_(0, ids, row_updates)`` applies
    the step under every backend."""
    fn = registry.lookup("pair", "adam_rows", backend, g.device)
    return fn(spec_m, spec_v, M, V, ids, g, step, lr=lr, b1=b1, b2=b2,
              eps=eps)


def update_read(spec, S, ids, delta, *, beta: float, scale: float,
                mask=None, backend: Optional[str] = None, sr_seed=None):
    """One fused EMA step on one sketch: ``(S', est)`` with row content
    moved to ``beta*content + scale*delta`` at ``ids`` (None: every row)
    and ``est`` the post-step estimate, S updated in place.  Dispatches on
    the store kind ('sketch' for signed specs, 'countmin' otherwise) and
    the device of ``delta``.  ``sr_seed``: the stochastic-rounding seed of
    bf16 and int8 cells (``quantize.step_seed``; None: the step-0 seed)."""
    kind = "sketch" if spec.signed else "countmin"
    fn = registry.lookup(kind, "update_read", backend, delta.device)
    return fn(spec, S, ids, delta, beta=beta, scale=scale, mask=mask,
              sr_seed=sr_seed)


def _slab_backend(kind: str, op: str, backend: Optional[str]) -> str:
    """None, 'auto' and backends with no slab op ('stream', 'tiled', e.g.
    a store pinned to 'tiled' for its dense path) resolve to 'xla'."""
    if backend in (None, "auto") or backend not in registry.backends(kind,
                                                                     op):
        return "xla"
    return backend


def update_slab(spec, slab, ids, delta, shard: int, *,
                backend: Optional[str] = None):
    """Scatter ``delta`` rows into ONE shard's (depth, local_width, dim)
    slab, IN PLACE; rows hashing outside the slab are dropped, so the
    shards' results concatenate to the full-width ``sketch.update``."""
    kind = "sketch" if spec.signed else "countmin"
    fn = registry.lookup(kind, "update_slab",
                         _slab_backend(kind, "update_slab", backend))
    return fn(spec, slab, ids, delta, shard)


def gather_slab(spec, slab, ids, shard: int, *,
                backend: Optional[str] = None):
    """This shard's (depth, k, dim) query cells, zero off-slab; their sum
    over the shards, finished by ``sketch.finish_query``, is the
    full-width ``sketch.query``."""
    kind = "sketch" if spec.signed else "countmin"
    fn = registry.lookup(kind, "gather_slab",
                         _slab_backend(kind, "gather_slab", backend))
    return fn(spec, slab, ids, shard)


register_backend("ref", ops.adam_rows_ref)
register_backend("xla", ops.adam_rows_xla)
register_backend("stream", ops.adam_rows_stream)
register_backend("tiled", ops.adam_rows_tiled)

for _kind in ("sketch", "countmin"):
    registry.register(_kind, "update_read", "ref", ops.ema_update_read_ref)
    registry.register(_kind, "update_read", "xla", ops.ema_update_read_xla)
    registry.register(_kind, "update_read", "tiled",
                      ops.ema_update_read_tiled)
    registry.register(_kind, "update_slab", "ref", cs.update_slab)
    registry.register(_kind, "update_slab", "xla", ops.slab_update_xla)
    registry.register(_kind, "gather_slab", "ref", cs.gather_slab)
    registry.register(_kind, "gather_slab", "xla", ops.slab_gather_xla)
del _kind
