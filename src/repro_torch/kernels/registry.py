"""The port's kernel-backend registry: (store kind, op) -> {backend: fn}.

Counterpart of ``repro.kernels.registry``, kept apart from it: the port
registers nothing there.  ``resolve(kind, op, None | 'auto', device)``
picks ``tiled`` for CUDA tensors and ``xla`` for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# (kind, op) -> {backend name: fn}, insertion-ordered per row.
_REGISTRY: Dict[Tuple[str, str], Dict[str, Callable]] = {}

_AUTO = {"cuda": "tiled"}
_AUTO_FALLBACK = "xla"


def register(kind: str, op: str, backend: str, fn: Callable) -> None:
    """Register (or override) one implementation of ``op`` for ``kind``."""
    _REGISTRY.setdefault((kind, op), {})[backend] = fn


def ops() -> Tuple[Tuple[str, str], ...]:
    return tuple(_REGISTRY)


def backends(kind: str, op: str) -> Tuple[str, ...]:
    """Backend names registered for (kind, op), registration order."""
    row = _REGISTRY.get((kind, op))
    if row is None:
        raise KeyError(f"no kernels registered for kind={kind!r} op={op!r}; "
                       f"rows: {ops()}")
    return tuple(row)


def resolve(kind: str, op: str, backend: Optional[str] = None,
            device=None) -> str:
    """Map None/'auto' to the best backend for tensors on ``device``
    (default: the CPU); validate explicit names."""
    names = backends(kind, op)
    if backend is None or backend == "auto":
        dev_type = torch.device(device).type if device is not None else "cpu"
        best = _AUTO.get(dev_type, _AUTO_FALLBACK)
        return best if best in names else names[0]
    if backend not in names:
        raise KeyError(f"unknown backend {backend!r} for kind={kind!r} "
                       f"op={op!r}; registered: {names}")
    return backend


def lookup(kind: str, op: str, backend: Optional[str] = None,
           device=None) -> Callable:
    return _REGISTRY[(kind, op)][resolve(kind, op, backend, device)]
