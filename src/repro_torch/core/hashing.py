"""Universal hash families for the count-sketch tensor, in PyTorch.

Counterpart of ``repro.core.hashing``: the same 2-universal
multiply-shift hashing with a splitmix32 finalizer, derived from one
integer seed, so a sketch built by either package addresses the same
buckets with the same signs.

The reference hashes with wrapping ``uint32`` arithmetic.  PyTorch's
``uint32`` tensors lack ``+``, ``>>`` and ``%`` on the CPU, so every value
here is a ``uint32`` held in an ``int64`` tensor and masked with
``& 0xFFFFFFFF`` after each step.  A 32×32-bit product is split at 16 bits
so that no ``int64`` product overflows.  Hashing runs on the device of
``ids``; each family's (a, b) parameters are drawn once and kept on each
device that hashes with them, so a call copies nothing from the host and
never waits for the device.  ``mach_class_hash`` builds MACH's class maps
on the host.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _derive_params(seed: int, depth: int) -> np.ndarray:
    """``depth`` (a, b) multiply-shift pairs, (depth, 2) uint32; ``a`` is
    odd.  Drawn on the host exactly as the reference draws them."""
    rng = np.random.RandomState(np.uint32(seed ^ 0x5EED5EED))
    a = rng.randint(0, 2**31, size=depth, dtype=np.int64).astype(np.uint32)
    a = (a << np.uint32(1)) | np.uint32(1)  # force odd
    b = rng.randint(0, 2**31, size=depth, dtype=np.int64).astype(np.uint32)
    return np.stack([a, b], axis=1)


def _derive_own_params(seed: int) -> np.ndarray:
    """The single (a, b) pair of the hash layout's ownership hash."""
    return _derive_params(int(seed) ^ 0x0517A2D5, 1)


def _u32(ids: torch.Tensor) -> torch.Tensor:
    """Integer ids as uint32 values in int64 (``-1`` -> ``0xFFFFFFFF``)."""
    return ids.to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64; ``c`` is an
    int or an int64 tensor that broadcasts against ``x``."""
    lo = x * (c & 0xFFFF)                        # < 2**48
    hi = (x * ((c >> 16) & 0xFFFF)) & 0xFFFF     # only 16 bits survive << 16
    return (lo + (hi << 16)) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    return x


@dataclasses.dataclass(frozen=True)
class HashFamily:
    """``depth`` independent 2-universal bucket hashes and sign hashes.

    ``identity=True`` is the exact-table test mode: ``h_j(i) = i mod
    width`` and ``s_j(i) = +1``.  ``shards``/``layout`` describe how the
    width axis partitions: ``'width'`` leaves the hash untouched,
    ``'hash'`` sends all of an id's rows into one shard's slab through an
    ownership hash.  With one shard both layouts are the classic family.
    """

    seed: int
    depth: int
    width: int
    identity: bool = False
    shards: int = 1
    layout: str = "width"

    def __post_init__(self):
        if self.layout not in ("width", "hash"):
            raise ValueError(f"unknown shard layout {self.layout!r} "
                             f"(expected 'width' or 'hash')")
        if self.shards < 1 or self.width % self.shards != 0:
            raise ValueError(f"width {self.width} must divide into "
                             f"{self.shards} shards")

    @property
    def params(self) -> np.ndarray:  # (depth, 2) uint32, host constant
        return _derive_params(self.seed, self.depth)

    @property
    def local_width(self) -> int:
        return self.width // self.shards

    def _rows_params(self, ids: torch.Tensor):
        """(a, b) as int64 tensors shaped (depth, 1, ..., 1) for ``ids``."""
        a, b = _params_on(self, ids.device)
        shape = (self.depth,) + (1,) * ids.dim()
        return a.reshape(shape), b.reshape(shape)

    def owner(self, ids: torch.Tensor) -> torch.Tensor:
        """Owning shard per id, int32 in [0, shards) (hash layout or
        identity mode only)."""
        if self.identity:
            return (ids.to(torch.int32) % self.width) // self.local_width
        if self.layout != "hash":
            raise ValueError("per-id ownership needs layout='hash'")
        a, b = (int(v) for v in _derive_own_params(self.seed)[0])
        h = _mix((_mul32(_u32(ids), a) + b) & _MASK)
        return (h % self.shards).to(torch.int32)

    def bucket(self, ids: torch.Tensor) -> torch.Tensor:
        """h_j(ids): (...,) -> (depth, ...) int32 in [0, width)."""
        if self.identity:
            out = ids.to(torch.int32)[None].expand((self.depth,) + ids.shape)
            return out % self.width
        a, b = self._rows_params(ids)
        h = _mix((_mul32(_u32(ids)[None], a) + b) & _MASK)
        if self.layout == "hash" and self.shards > 1:
            local = (h % self.local_width).to(torch.int32)
            return self.owner(ids)[None] * self.local_width + local
        return (h % self.width).to(torch.int32)

    def sign(self, ids: torch.Tensor) -> torch.Tensor:
        """s_j(ids): (...,) -> (depth, ...) float32 in {+1, -1}."""
        if self.identity:
            return torch.ones((self.depth,) + ids.shape, dtype=torch.float32,
                              device=ids.device)
        a, b = self._rows_params(ids)
        x = (_u32(ids) + _GOLDEN) & _MASK
        h = _mix((_mul32(x[None], b) + a) & _MASK)
        return torch.where((h >> 31) == 0, 1.0, -1.0).to(torch.float32)


@functools.lru_cache(maxsize=64)
def _params_on(family: HashFamily, device: torch.device):
    """A family's (a, b) as (depth,) int64 tensors on ``device``: drawn and
    copied once per (family, device).  The copy to a card waits for it,
    so it must not happen inside a step."""
    p = torch.as_tensor(family.params.astype(np.int64), device=device)
    return p[:, 0].contiguous(), p[:, 1].contiguous()


# classes hashed at a time by mach_class_hash: its int64 temporaries stay
# near 8 MB each
MACH_CHUNK = 1 << 20


def mach_class_hash(seed: int, num_classes: int, num_buckets: int,
                    num_hashes: int) -> np.ndarray:
    """MACH meta-class assignment (paper §7.3): ``num_hashes`` independent
    maps [num_classes] -> [num_buckets] as (num_hashes, num_classes)
    int32, hashed on the host in chunks of ``MACH_CHUNK`` classes."""
    fam = HashFamily(seed=seed, depth=num_hashes, width=num_buckets)
    out = np.empty((num_hashes, num_classes), dtype=np.int32)
    for lo in range(0, num_classes, MACH_CHUNK):
        hi = min(num_classes, lo + MACH_CHUNK)
        ids = torch.arange(lo, hi, dtype=torch.int32)
        out[:, lo:hi] = fam.bucket(ids).numpy()
    return out
