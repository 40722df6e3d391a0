"""The sketches' addressing: a frozen copy of the port's hash arithmetic.

Copied from ``src/repro_torch/core/hashing.py`` (``_derive_params``,
``_mul32``, ``_mix``, ``HashFamily.bucket``/``sign`` for one shard, no
identity mode) and ``src/repro_torch/core/stores.py::leaf_seed`` and
``core/sketch.py::for_param``'s width rule, at commit 5fd53a1.  A
2-universal multiply-shift hash with a splitmix32 finalizer; uint32
values are held in int64 and masked after each step.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def leaf_seed(path: str, base_seed: int = 0) -> int:
    """The hash seed of the sketch at a parameter path."""
    return (zlib.crc32(path.encode()) ^ (base_seed * 0x9E3779B1)) \
        & 0x7FFFFFFF


def sketch_width(n: int, compression: float = 5.0, depth: int = 3,
                 width_multiple: int = 256) -> int:
    """Buckets of an (n, d) table's sketch at ``compression``."""
    w = max(int(n / (compression * depth)), 1)
    w = -(-w // width_multiple) * width_multiple
    return min(w, max(n, width_multiple))


def hash_params(seed: int, depth: int) -> np.ndarray:
    """(depth, 2) uint32 (a, b) pairs; ``a`` odd."""
    rng = np.random.RandomState(np.uint32(seed ^ 0x5EED5EED))
    a = rng.randint(0, 2**31, size=depth, dtype=np.int64).astype(np.uint32)
    a = (a << np.uint32(1)) | np.uint32(1)
    b = rng.randint(0, 2**31, size=depth, dtype=np.int64).astype(np.uint32)
    return np.stack([a, b], axis=1)


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = (x * ((c >> 16) & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


class Hash:
    """``depth`` bucket hashes into ``width`` and sign hashes."""

    def __init__(self, seed: int, depth: int, width: int):
        self.seed, self.depth, self.width = int(seed), int(depth), int(width)
        self._p = hash_params(self.seed, self.depth).astype(np.int64)

    def _ab(self, ids: torch.Tensor):
        p = torch.as_tensor(self._p, device=ids.device)
        return p[:, 0, None], p[:, 1, None]

    def bucket(self, ids: torch.Tensor) -> torch.Tensor:
        """(k,) ids -> (depth, k) int64 buckets."""
        a, b = self._ab(ids)
        u = ids.to(torch.int64) & _MASK
        return _mix((_mul32(u[None], a) + b) & _MASK) % self.width

    def sign(self, ids: torch.Tensor) -> torch.Tensor:
        """(k,) ids -> (depth, k) float32 signs in {+1, -1}."""
        a, b = self._ab(ids)
        x = ((ids.to(torch.int64) & _MASK) + _GOLDEN) & _MASK
        h = _mix((_mul32(x[None], b) + a) & _MASK)
        return torch.where((h >> 31) == 0, 1.0, -1.0).to(torch.float32)
