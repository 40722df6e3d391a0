"""Hopper kernels and the backends of the sparse-rows CS-Adam step.

  cs_adam_tiled.py — B1, batch-parallel CS-Adam over deduplicated rows
                     (CUDA, ``csrc/cs_adam_tiled.cu``)
  cs_adam.py       — B2, streaming CS-Adam in exact per-item order
                     (CUDA, ``csrc/cs_adam.cu``)
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
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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
    for ``V``'s device).  Returns ``(M', V', row_updates)``, the sketches
    updated in place; ``table.index_add_(0, ids, row_updates)`` applies
    the step under every backend."""
    fn = registry.lookup("pair", "adam_rows", backend, V.device)
    return fn(spec_m, spec_v, M, V, ids, g, step, lr=lr, b1=b1, b2=b2,
              eps=eps)


register_backend("ref", ops.adam_rows_ref)
register_backend("xla", ops.adam_rows_xla)
register_backend("stream", ops.adam_rows_stream)
register_backend("tiled", ops.adam_rows_tiled)
