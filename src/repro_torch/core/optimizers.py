"""Count-sketch CS-Adam for one table fed (ids, rows) gradients.

Counterpart of the sparse-rows part of ``repro.core.optimizers``:
``sparse_rows_adam`` is ``chain(scale_by_adam_rows(...), scale_by_lr(lr))``
presented in the reference's ``{"step", "m", "v"}`` state layout, and
``apply_sparse_updates`` adds its row updates into the table in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import sketch as cs
from repro_torch.core import transforms as T
from repro_torch.core.cleaning import CleaningSchedule
from repro_torch.core.stores import CountMinStore, CountSketchStore, leaf_seed
from repro_torch.core.transforms import Schedule, Transform


@dataclasses.dataclass(frozen=True)
class SketchHParams:
    """How sketched leaves are sized (the reference's fields for the
    sparse-rows path).  ``compression`` is n·d / (depth·width·d);
    ``backend`` names a registered kernel backend ('ref' | 'xla' |
    'stream' | 'tiled') or 'auto' (tiled for CUDA tensors, xla for CPU
    tensors); ``overrides`` pins (depth, width) per path."""
    compression: float = 5.0
    depth: int = 3
    width_multiple: int = 256
    seed: int = 0
    identity: bool = False
    backend: Optional[str] = None
    dtype: str = "float32"
    overrides: Tuple[Tuple[str, Tuple[int, int]], ...] = ()

    def override_for(self, path: str) -> Optional[Tuple[int, int]]:
        for p, dw in self.overrides:
            if p == path:
                return dw
        return None

    def spec(self, path: str, shape, *, signed: bool) -> cs.SketchSpec:
        dw = self.override_for(path)
        if dw is not None:
            if len(shape) != 2:
                raise ValueError(f"sketch override at {path!r} needs a "
                                 f"rank-2 leaf, got {tuple(shape)}")
            depth, width = dw
            return cs.SketchSpec(depth=int(depth), width=int(width),
                                 dim=int(shape[1]), signed=signed,
                                 seed=leaf_seed(path, self.seed),
                                 dtype=self.dtype, identity=self.identity)
        return cs.for_param(tuple(shape), compression=self.compression,
                            depth=self.depth, signed=signed,
                            seed=leaf_seed(path, self.seed),
                            width_multiple=self.width_multiple,
                            dtype=self.dtype, identity=self.identity)


def _with_lr(rule: Transform, lr: Schedule) -> Transform:
    """``chain(rule, scale_by_lr(lr))`` in the legacy state layout: the
    rule's ``{"step", ...}`` dict IS the optimizer state, and the lr
    link's step counter is rebuilt from it."""
    chained = T.chain(rule, T.scale_by_lr(lr))

    def init(params=None):
        state, _lr_state = chained.init(params)
        return state

    def update(grads, state, params=None):
        u, (state, _lr_state) = chained.update(
            grads, (state, {"step": state["step"]}), params)
        return u, state

    return Transform(init, update)


def sparse_rows_adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, *, shape: Tuple[int, int],
                     path: str = "sparse_rows",
                     hparams: SketchHParams = SketchHParams(),
                     track_first_moment: bool = True,
                     cleaning: Optional[CleaningSchedule] = None,
                     m_store=None, v_store=None,
                     device="cuda") -> Transform:
    """CS-Adam for ONE (n, d) table fed ``{"ids": (k,), "rows": (k, d)}``
    gradients, its sketches on ``device``.  Each update runs through the
    backend named by the v store or ``hparams.backend`` ('auto' when
    neither names one).  ``track_first_moment=False`` is the β₁=0 variant
    (Theorem 5.1)."""
    m_store, v_store = _sparse_rows_stores(
        shape, path, hparams, track_first_moment=track_first_moment,
        cleaning=cleaning, m_store=m_store, v_store=v_store)
    # a backend pinned on the store itself wins over the hparams knob
    backend = getattr(v_store, "backend", None) or hparams.backend
    rule = T.scale_by_adam_rows(
        b1=b1, b2=b2, eps=eps, m_store=m_store, v_store=v_store,
        backend=backend if backend is not None else "auto", device=device)
    return _with_lr(rule, lr)


def _sparse_rows_stores(shape: Tuple[int, int], path: str,
                        hparams: SketchHParams, *,
                        track_first_moment: bool,
                        cleaning: Optional[CleaningSchedule],
                        m_store, v_store):
    """The (m_store, v_store) pair: ``hparams`` sizing unless explicit
    stores are given, with the reference's cleaning guards."""
    shape = tuple(int(s) for s in shape)
    if v_store is None:
        v_store = CountMinStore(spec=hparams.spec(path, shape, signed=False),
                                cleaning=cleaning, shape=shape)
    elif cleaning is not None:
        if not isinstance(v_store, CountMinStore):
            raise ValueError(
                f"cleaning is a Count-Min hook (paper §4); the given "
                f"v_store is a {type(v_store).__name__}")
        if v_store.cleaning is None:
            v_store = dataclasses.replace(v_store, cleaning=cleaning)
        elif v_store.cleaning != cleaning:
            raise ValueError(
                f"conflicting cleaning schedules: v_store carries "
                f"{v_store.cleaning} but cleaning={cleaning} was also "
                f"passed; set exactly one")
    if m_store is None and track_first_moment:
        m_store = CountSketchStore(spec=hparams.spec(path, shape, signed=True),
                                   shape=shape)
    return (m_store if track_first_moment else None), v_store


def sparse_rows_stores(shape: Tuple[int, int], path: str = "sparse_rows",
                       hparams: SketchHParams = SketchHParams(), *,
                       track_first_moment: bool = True,
                       cleaning: Optional[CleaningSchedule] = None,
                       m_store=None, v_store=None):
    """The exact (m_store, v_store) pair ``sparse_rows_adam`` binds for the
    same arguments."""
    return _sparse_rows_stores(shape, path, hparams,
                               track_first_moment=track_first_moment,
                               cleaning=cleaning, m_store=m_store,
                               v_store=v_store)


def apply_sparse_updates(table: torch.Tensor, updates) -> torch.Tensor:
    """Add ``sparse_rows_adam`` row updates at their ids, IN PLACE
    (correct under every backend).  Returns ``table``."""
    return table.index_add_(0, updates["ids"].long(),
                            updates["rows"].to(table.dtype))
