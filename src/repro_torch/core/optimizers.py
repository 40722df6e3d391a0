"""Count-sketch optimizers (paper §4, Algorithms 2-4) and the dense
baselines they are measured against.

Counterpart of ``repro.core.optimizers``.  Every entry point is ``chain(
rule, scale_by_lr(lr))`` presented in the reference's ``{"step", "m",
"v"}`` state layout, with None, dense or sketch leaves per path:

    opt = countsketch_adam(lr, policy=SketchPolicy())    # dense gradients
    state = opt.init(params)
    updates, state = opt.update(grads, state)
    params = apply_updates(params, updates)              # in place

``sparse_rows_adam`` is the same rule for one table fed ``{"ids",
"rows"}`` gradients, applied with ``apply_sparse_updates``.  The legacy
``policy``/``hparams.overrides`` dispatch is bridged onto a ``StoreTree``
by ``stores_from_policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import sketch as cs
from repro_torch.core import transforms as T
from repro_torch.core.cleaning import CleaningSchedule
from repro_torch.core.partition import PolicyFn, nothing_policy
from repro_torch.core.stores import (CountMinStore, CountSketchStore,
                                     DenseStore, StoreTree, leaf_seed)
from repro_torch.core.transforms import Schedule, Transform
from repro_torch.kernels import registry


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, IN PLACE (None updates leave
    the leaf as it is).  Returns ``params``."""
    def leaf(_path, p, u):
        if u is not None:
            with torch.no_grad():
                p.add_(u.to(p.dtype))
        return p
    return T.tree_map_with_path(leaf, params, updates)


@dataclasses.dataclass(frozen=True)
class SketchHParams:
    """How sketched leaves are sized and run, the reference's fields.
    ``compression`` is n·d / (depth·width·d).  ``strict_paper``: the
    3-pass query-update-query form.  ``dense_chunk``: the row chunk of
    the composed dense path (0: unchunked).  ``lazy``: rows whose
    gradient is all zero get no update and no sketch write.  ``backend``
    names a registered kernel backend ('ref' | 'xla' | 'stream' |
    'tiled') or 'auto' (tiled for CUDA tensors, xla for CPU tensors); it
    routes the sparse-rows step and the dense path's fused ``update_read``
    of every sketch store these hparams make, where None keeps the
    composed form and 'stream' (sparse-rows only) counts as None.
    ``overrides`` pins (depth, width) per path."""
    compression: float = 5.0
    depth: int = 3
    width_multiple: int = 256
    seed: int = 0
    identity: bool = False
    strict_paper: bool = False
    dense_chunk: int = 8192
    lazy: bool = True
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


def _update_read_backend(backend: Optional[str]) -> Optional[str]:
    """``hparams.backend`` for the dense path's fused op: names registered
    for ('sketch', 'update_read') and 'auto' pass, sparse-rows-only names
    ('stream') map to None, the composed form."""
    if backend is None or backend == "auto":
        return backend
    return backend if backend in registry.backends("sketch", "update_read") \
        else None


def stores_from_policy(policy: PolicyFn = nothing_policy, *,
                       rank1_policy: PolicyFn = nothing_policy,
                       hparams: SketchHParams = SketchHParams(),
                       cleaning: Optional[CleaningSchedule] = None,
                       track_first_moment: bool = True,
                       sketch_first_moment: bool = True,
                       rule: str = "adam") -> StoreTree:
    """Bridge the legacy ``policy``/``overrides`` dispatch onto a
    ``StoreTree``; per-leaf specs are ``hparams.spec``'s, the reference's.
    ``rule``: 'adam' fills (m, v), 'momentum' a signed sketch in the m
    slot only, 'adagrad' a count-min in the v slot only.  A
    ``rank1_policy`` other than ``nothing_policy`` raises: rank-1 stores
    arrive with ROADMAP A9."""
    if rank1_policy is not nothing_policy:
        raise NotImplementedError("rank1_policy needs Rank1Store, which is "
                                  "not ported yet (ROADMAP A9)")
    track = track_first_moment
    backend = _update_read_backend(hparams.backend)

    def sketch(path, shape, signed):
        if signed:
            return CountSketchStore(spec=hparams.spec(path, shape,
                                                      signed=True),
                                    backend=backend)
        return CountMinStore(spec=hparams.spec(path, shape, signed=False),
                             cleaning=cleaning, backend=backend)

    if rule == "momentum":
        return StoreTree(default_m=DenseStore(), default_v=None,
                         resolver=lambda path, shape: (
                             (sketch(path, shape, True), None)
                             if policy(path, shape) else None))
    if rule == "adagrad":
        return StoreTree(default_m=None, default_v=DenseStore(),
                         resolver=lambda path, shape: (
                             (None, sketch(path, shape, False))
                             if policy(path, shape) else None))
    if rule != "adam":
        raise ValueError(f"unknown rule {rule!r} (adam | momentum | adagrad)")
    dense_m = DenseStore() if track else None

    def resolver(path, shape):
        if not policy(path, shape):
            return None
        m = sketch(path, shape, True) if track and sketch_first_moment \
            else dense_m
        return m, sketch(path, shape, False)

    return StoreTree(default_m=dense_m, default_v=DenseStore(),
                     resolver=resolver)


def adam_from_stores(lr: Schedule, stores: StoreTree, *, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     dense_chunk: int = 8192, lazy: bool = True,
                     strict_paper: bool = False) -> Transform:
    """``chain(scale_by_adam(stores=...), scale_by_lr(lr))`` in the legacy
    ``{"step", "m", "v"}`` state layout."""
    return _with_lr(T.scale_by_adam(b1=b1, b2=b2, eps=eps, stores=stores,
                                    dense_chunk=dense_chunk, lazy=lazy,
                                    strict_paper=strict_paper), lr)


def adagrad_from_stores(lr: Schedule, stores: StoreTree, *,
                        eps: float = 1e-10, dense_chunk: int = 8192,
                        strict_paper: bool = False) -> Transform:
    """``chain(scale_by_adagrad(stores=...), scale_by_lr(lr))`` in the
    legacy ``{"step", "v"}`` state layout."""
    return _with_lr(T.scale_by_adagrad(eps, stores=stores,
                                       dense_chunk=dense_chunk,
                                       strict_paper=strict_paper), lr)


def sgd(lr: Schedule) -> Transform:
    return T.scale_by_lr(lr)


def momentum(lr: Schedule, gamma: float = 0.9) -> Transform:
    """Dense Polyak momentum: m <- γm + g; x <- x - ηm."""
    return _with_lr(T.scale_by_momentum(gamma), lr)


def adagrad(lr: Schedule, eps: float = 1e-10) -> Transform:
    return _with_lr(T.scale_by_adagrad(eps), lr)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    return _with_lr(T.scale_by_adam(b1=b1, b2=b2, eps=eps), lr)


def countsketch_momentum(lr: Schedule, gamma: float = 0.9, *,
                         policy: PolicyFn = nothing_policy,
                         hparams: SketchHParams = SketchHParams()
                         ) -> Transform:
    """Paper Alg. 2.  Linear form: m += (γ-1)·m_{t-1} + g."""
    stores = stores_from_policy(policy, hparams=hparams, rule="momentum")
    return _with_lr(T.scale_by_momentum(
        gamma, stores=stores, dense_chunk=hparams.dense_chunk,
        lazy=hparams.lazy, strict_paper=hparams.strict_paper), lr)


def countsketch_adagrad(lr: Schedule, eps: float = 1e-10, *,
                        policy: PolicyFn = nothing_policy,
                        hparams: SketchHParams = SketchHParams(),
                        cleaning: Optional[CleaningSchedule] = None
                        ) -> Transform:
    """Paper Alg. 3: the cumulative squared gradient in a Count-Min."""
    stores = stores_from_policy(policy, hparams=hparams, cleaning=cleaning,
                                rule="adagrad")
    return _with_lr(T.scale_by_adagrad(
        eps, stores=stores, dense_chunk=hparams.dense_chunk,
        strict_paper=hparams.strict_paper), lr)


def countsketch_adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, *,
                     policy: PolicyFn = nothing_policy,
                     rank1_policy: PolicyFn = nothing_policy,
                     hparams: SketchHParams = SketchHParams(),
                     cleaning: Optional[CleaningSchedule] = None,
                     track_first_moment: bool = True,
                     sketch_first_moment: bool = True) -> Transform:
    """Paper Alg. 4: the 1st moment in a Count-Sketch (median read), the
    2nd in a Count-Min (min read) with optional cleaning, on the leaves
    ``policy`` selects; dense Adam elsewhere.  ``track_first_moment=
    False`` is the β₁=0 variant of Theorem 5.1; ``sketch_first_moment=
    False`` the paper's CS-V ablation (dense 1st moment)."""
    stores = stores_from_policy(
        policy, rank1_policy=rank1_policy, hparams=hparams,
        cleaning=cleaning, track_first_moment=track_first_moment,
        sketch_first_moment=sketch_first_moment)
    return adam_from_stores(lr, stores, b1=b1, b2=b2, eps=eps,
                            dense_chunk=hparams.dense_chunk,
                            lazy=hparams.lazy,
                            strict_paper=hparams.strict_paper)


def countsketch_rmsprop(lr: Schedule, b2: float = 0.999, eps: float = 1e-8,
                        *, policy: PolicyFn = nothing_policy,
                        hparams: SketchHParams = SketchHParams(),
                        cleaning: Optional[CleaningSchedule] = None
                        ) -> Transform:
    """The β₁=0 optimizer of Theorem 5.1, ``chain(scale_by_rmsprop(...),
    scale_by_lr(lr))``."""
    stores = stores_from_policy(policy, hparams=hparams, cleaning=cleaning,
                                track_first_moment=False,
                                sketch_first_moment=False)
    return _with_lr(T.scale_by_rmsprop(
        b2=b2, eps=eps, stores=stores, dense_chunk=hparams.dense_chunk,
        lazy=hparams.lazy, strict_paper=hparams.strict_paper), lr)


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
    if hparams.strict_paper:
        raise ValueError("sparse_rows_adam runs through the kernel "
                         "registry, which has no strict_paper (3-pass) path")
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
