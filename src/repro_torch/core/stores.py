"""Sketch-backed AuxStore codecs and the StoreTree resolver, f32 cells.

Counterpart of the sparse-rows part of ``repro.core.stores``:

  * ``CountSketchStore`` — signed Count-Sketch, median read (Adam's 1st
    moment);
  * ``CountMinStore``    — unsigned Count-Min, min read, with the paper's
    §4 cleaning as its ``clean`` hook (Adam's 2nd moment);
  * ``StoreTree``        — path -> (m_store, v_store).

Stores are frozen dataclasses that double as factories: ``bind(path,
shape, dtype)`` sizes the sketch for one table with the same per-leaf
seed (``leaf_seed``) as the reference, so both packages address the same
buckets.  ``accumulate``/``decay`` write the state IN PLACE.  The dense
and rank-1 stores, the fused ``update_read`` and the JSON round-trip
arrive with ROADMAP A6 and A9.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import sketch as cs
from repro_torch.core.cleaning import CleaningSchedule, maybe_clean
from repro_torch.core.sketch import SketchSpec


def leaf_seed(path: str, base_seed: int) -> int:
    """Per-leaf hash seed, the reference's derivation."""
    return (zlib.crc32(path.encode()) ^ (base_seed * 0x9E3779B1)) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class _SketchStoreBase:
    """Shared machinery of the two sketch codecs.  ``compression`` sizes
    the sketch like ``sketch.for_param``; an explicit ``width`` pins it;
    an explicit ``spec`` bypasses sizing.  ``backend`` names the kernel
    backend of the sparse-rows step (see ``repro_torch.kernels``)."""

    compression: float = 5.0
    depth: int = 3
    width: Optional[int] = None
    width_multiple: int = 256
    seed: int = 0
    dtype: str = "float32"
    identity: bool = False
    shards: int = 1
    shard_layout: str = "width"
    spec: Optional[SketchSpec] = None
    shape: Optional[Tuple[int, int]] = None
    backend: Optional[str] = None

    kind = "abstract"
    _signed = True

    def accepts(self, shape) -> bool:
        return len(shape) == 2

    def bind(self, path: str, shape, dtype=None) -> "_SketchStoreBase":
        shape = tuple(int(s) for s in shape)
        if self.spec is not None:
            return self if self.shape is not None \
                else dataclasses.replace(self, shape=shape)
        if len(shape) != 2:
            raise ValueError(f"{type(self).__name__} needs a rank-2 "
                             f"(rows, dim) leaf, got {shape} at {path!r}")
        if self.width is not None:
            spec = SketchSpec(depth=int(self.depth), width=int(self.width),
                              dim=shape[1], signed=self._signed,
                              seed=leaf_seed(path, self.seed),
                              dtype=self.dtype, identity=self.identity)
        else:
            spec = cs.for_param(shape, compression=self.compression,
                                depth=self.depth, signed=self._signed,
                                seed=leaf_seed(path, self.seed),
                                width_multiple=self.width_multiple,
                                dtype=self.dtype, identity=self.identity)
        if self.shards != 1 or self.shard_layout != "width":
            spec = dataclasses.replace(spec, shards=int(self.shards),
                                       layout=self.shard_layout)
        return dataclasses.replace(self, spec=spec, shape=shape)

    def _rows(self, rows, device) -> torch.Tensor:
        if rows is not None:
            return rows
        if self.shape is None:
            raise ValueError("rows=None needs a store bound to a table shape")
        return torch.arange(self.shape[0], dtype=torch.int32, device=device)

    def init(self, device="cuda") -> torch.Tensor:
        return cs.init(self.spec, device)

    def accumulate(self, state, delta, rows=None, *, scale: float = 1.0):
        if scale != 1.0:
            delta = scale * delta
        return cs.update(self.spec, state, self._rows(rows, state.device),
                         delta)

    def decay(self, state, beta):
        return cs.decay(state, beta)

    def read(self, state, rows=None):
        return cs.query(self.spec, state, self._rows(rows, state.device))

    def bytes(self, state=None) -> int:
        return self.spec.nbytes()

    def clean(self, state, step):
        """Cleaning hook (paper §4): identity except on ``CountMinStore``."""
        return state


@dataclasses.dataclass(frozen=True)
class CountSketchStore(_SketchStoreBase):
    """Signed Count-Sketch (median read): momentum, Adam's 1st moment."""
    kind = "sketch"
    _signed = True


@dataclasses.dataclass(frozen=True)
class CountMinStore(_SketchStoreBase):
    """Unsigned Count-Min (min read): Adagrad, Adam's 2nd moment.
    ``cleaning`` decays the state in place before each due step's reads."""
    cleaning: Optional[CleaningSchedule] = None

    kind = "countmin"
    _signed = False

    def clean(self, state, step):
        return maybe_clean(self.cleaning, state, step)


StoreResolver = Callable[[str, Tuple[int, ...]],
                         Optional[Tuple[Optional[Any], Optional[Any]]]]


@dataclasses.dataclass(frozen=True)
class StoreTree:
    """path -> (m_store, v_store).  Resolution order: ``resolver`` >
    exact-path ``rules`` > defaults.  ``None`` in the m slot means no
    first moment (β₁=0).  The reference's default ``DenseStore`` is not
    ported yet, so the defaults here are None."""

    rules: Tuple[Tuple[str, Optional[Any], Optional[Any]], ...] = ()
    default_m: Optional[Any] = None
    default_v: Optional[Any] = None
    resolver: Optional[StoreResolver] = None

    def resolve(self, path: str, shape, dtype=None):
        """The bound ``(m_store, v_store)`` pair for one parameter leaf."""
        pair = self.resolver(path, tuple(shape)) if self.resolver else None
        if pair is None:
            for p, m, v in self.rules:
                if p == path:
                    pair = (m, v)
                    break
        if pair is None:
            pair = (self.default_m, self.default_v)
        m, v = pair
        return (None if m is None else m.bind(path, shape, dtype),
                None if v is None else v.bind(path, shape, dtype))
