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
"rows"}`` gradients, applied with ``apply_sparse_updates``, and
``sparse_rows_adam_dp`` its data-parallel form, applied with
``apply_unique_updates``; ``adam_sparse_rows`` and ``momentum_sparse_rows`` are the functional
steps on sketch states (the former also the only 3-pass
``strict_paper`` sparse path).  The legacy ``policy``/
``hparams.overrides`` dispatch is bridged onto a ``StoreTree`` by
``stores_from_policy``.  ``linear_decay`` is a schedule and
``state_bytes`` counts a state's bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import sketch as cs
from repro_torch.core import transforms as T
from repro_torch.core.cleaning import CleaningSchedule, maybe_clean
from repro_torch.core.partition import PolicyFn, nothing_policy
from repro_torch.core.stores import (CountMinStore, CountSketchStore,
                                     DenseStore, Rank1Store, StoreTree,
                                     leaf_seed, tree_bytes)
from repro_torch.core.transforms import Schedule, Transform
from repro_torch.kernels import dedup, registry
from repro_torch.kernels.ops import bias_correction
from repro_torch.kernels.ref import true_div


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
    slot only, 'adagrad' a count-min in the v slot only.  Under 'adam',
    ``rank1_policy`` (checked first) puts a leaf's 2nd moment in a
    ``Rank1Store`` beside a dense 1st moment (LR-NMF-V)."""
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
        if rank1_policy(path, shape):
            return dense_m, Rank1Store()
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


def _eta(lr: Schedule, step) -> float:
    """The learning rate at ``step`` as a float32 value."""
    return float(np.float32(T._lr_at(lr, step)))


def adam_sparse_rows(spec_m: Optional[cs.SketchSpec], spec_v: cs.SketchSpec,
                     M, V, ids: torch.Tensor, g: torch.Tensor, step, *,
                     lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8,
                     cleaning: Optional[CleaningSchedule] = None,
                     strict_paper: bool = False,
                     backend: Optional[str] = None):
    """CS-Adam on ``k`` touched rows, lr fused: ``(M', V', row_updates)``,
    the sketches updated IN PLACE; ``spec_m``/``M`` None is the β₁=0
    variant.  ``step`` is the host step counter.

    ``backend`` runs the step through ``kernels.adam_rows`` after the
    cleaning hook ('ref' | 'xla' | 'stream' | 'tiled' | 'auto'), which
    handles duplicate ids itself.  ``backend=None`` is the in-graph batch
    path, where ``ids`` must already be unique (``dedup.dedup_rows``);
    ``strict_paper`` (3-pass: update, then query) exists only there."""
    if backend is not None:
        if strict_paper:
            raise ValueError("strict_paper is only supported on the "
                             "default (backend=None) path")
        V_in = maybe_clean(cleaning, V, step)
        return kernels.adam_rows(spec_m, spec_v, M, V_in, ids, g, step,
                                 lr=lr, b1=b1, b2=b2, eps=eps,
                                 backend=backend)
    eta, t = _eta(lr, step), int(step)
    write = cs.query_after_update if strict_paper else cs.update_and_query
    if spec_m is not None:
        m_old = cs.query(spec_m, M, ids)
        M, m_new = write(spec_m, M, ids, (1.0 - b1) * (g - m_old))
        mhat = true_div(m_new, bias_correction(b1, t))
    else:
        mhat = g
    V = maybe_clean(cleaning, V, step)
    v_old = cs.query(spec_v, V, ids)
    V, v_new = write(spec_v, V, ids, (1.0 - b2) * (g * g - v_old))
    vhat = true_div(torch.clamp_min(v_new, 0.0), bias_correction(b2, t))
    return M, V, -eta * mhat / (torch.sqrt(vhat) + eps)


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
        raise ValueError("sparse_rows_adam always runs through the kernel "
                         "registry, which has no strict_paper (3-pass) "
                         "path: use adam_sparse_rows(backend=None, "
                         "strict_paper=True) instead")
    m_store, v_store = _sparse_rows_stores(
        shape, path, hparams, track_first_moment=track_first_moment,
        cleaning=cleaning, m_store=m_store, v_store=v_store)
    # a backend pinned on the store itself wins over the hparams knob
    backend = getattr(v_store, "backend", None) or hparams.backend
    rule = T.scale_by_adam_rows(
        b1=b1, b2=b2, eps=eps, m_store=m_store, v_store=v_store,
        backend=backend if backend is not None else "auto", device=device)
    return _with_lr(rule, lr)


def sparse_rows_adam_dp(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, *, shape: Tuple[int, int],
                        path: str = "sparse_rows", axis_name="data",
                        hparams: SketchHParams = SketchHParams(),
                        track_first_moment: bool = True,
                        cleaning: Optional[CleaningSchedule] = None,
                        error_feedback: bool = False,
                        dir_clip: Optional[float] = 10.0,
                        m_store=None, v_store=None,
                        device="cuda") -> Transform:
    """Data-parallel ``sparse_rows_adam``: the same store derivation and
    ``{"step", "m", "v", "residual"}`` state layout as the reference, but
    each replica of ``axis_name`` (a ``dp_axis``) calls ``update`` with
    its own gradient shard; the collectives all-reduce the (depth, width,
    dim) gradient sketches instead of the (k, d) rows
    (``scale_by_adam_rows_dp``).  The emitted ``{"ids", "rows"}`` are at
    the global unique ids, padded past the table's end: apply them with
    ``apply_unique_updates``.  The step runs the plain sketch ops whatever
    the backend (on a card every sketch write is B5), as the reference's
    does."""
    m_store, v_store = _sparse_rows_stores(
        shape, path, hparams, track_first_moment=track_first_moment,
        cleaning=cleaning, m_store=m_store, v_store=v_store)
    rule = T.scale_by_adam_rows_dp(
        b1=b1, b2=b2, eps=eps, m_store=m_store, v_store=v_store,
        axis_name=axis_name, error_feedback=error_feedback,
        dir_clip=dir_clip, device=device)
    return _with_lr(rule, lr)


def sparse_rows_adam_sharded(lr: Schedule, b1: float = 0.9,
                             b2: float = 0.999, eps: float = 1e-8, *,
                             shape: Tuple[int, int],
                             path: str = "sparse_rows", shards: int,
                             shard_layout: str = "width",
                             shard_axis="model", dp_axis=None,
                             hparams: SketchHParams = SketchHParams(),
                             track_first_moment: bool = True,
                             cleaning: Optional[CleaningSchedule] = None,
                             error_feedback: bool = False,
                             dir_clip: Optional[float] = 10.0,
                             m_store=None, v_store=None,
                             device="cuda") -> Transform:
    """``sparse_rows_adam_dp`` with the sketch state sharded over
    ``shard_axis`` into ``shards`` width slabs: the same store derivation
    and ``{"step", "m", "v", "residual"}`` layout, the state given to
    ``update`` one replica's slabs (``scale_by_adam_rows_sharded``).
    ``shard_layout`` 'width' leaves the hashing as it is (the state is
    byte-identical to the unsharded run's); 'hash' sends all of an id's
    rows to one owning shard.  Explicit stores are re-stamped with the
    requested sharding (``with_sharding``), so planner StoreTrees
    compose."""
    m_store, v_store = _sparse_rows_stores(
        shape, path, hparams, track_first_moment=track_first_moment,
        cleaning=cleaning, m_store=m_store, v_store=v_store)
    if v_store.spec is None or v_store.spec.shards != shards \
            or v_store.spec.layout != shard_layout:
        v_store = v_store.with_sharding(shards, shard_layout)
    if m_store is not None and (
            m_store.spec is None or m_store.spec.shards != shards
            or m_store.spec.layout != shard_layout):
        m_store = m_store.with_sharding(shards, shard_layout)
    backend = getattr(v_store, "backend", None) or hparams.backend
    rule = T.scale_by_adam_rows_sharded(
        b1=b1, b2=b2, eps=eps, m_store=m_store, v_store=v_store,
        shard_axis=shard_axis, dp_axis=dp_axis,
        error_feedback=error_feedback, dir_clip=dir_clip, backend=backend,
        device=device)
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


# backends whose row updates carry each id's whole update at its first
# occurrence and zeros at later ones (the dedup pre-pass)
FIRST_OCCURRENCE_BACKENDS = ("xla", "tiled")


def first_occurrence_only(hparams: SketchHParams, v_store=None,
                          device="cuda") -> bool:
    """True when the backend ``sparse_rows_adam`` binds for ``hparams``
    and ``v_store`` on ``device`` is one of ``FIRST_OCCURRENCE_BACKENDS``:
    its updates may then be applied with ``first_only=True``."""
    backend = getattr(v_store, "backend", None) or hparams.backend
    return registry.resolve("pair", "adam_rows", backend, device) \
        in FIRST_OCCURRENCE_BACKENDS


def apply_sparse_updates(table: torch.Tensor, updates, *,
                         first_only: bool = False) -> torch.Tensor:
    """Add ``sparse_rows_adam`` row updates at their ids, IN PLACE
    (correct under every backend), each id's rows added in item order
    from the table's value, as the reference's ``table.at[ids].add``
    (``dedup.index_add_rows``).  ``first_only``: the caller knows later
    occurrences carry zeros, so no order can change the bits and one
    ``index_add_`` applies them.  Returns ``table``."""
    if first_only:
        return table.index_add_(0, updates["ids"].long(),
                                updates["rows"].to(table.dtype))
    return dedup.index_add_rows(table, updates["ids"], updates["rows"])


def apply_unique_updates(table: torch.Tensor, updates) -> torch.Tensor:
    """Add row updates at sorted unique ids followed by padding ids past
    the table's end (the data-parallel step's global id set), IN PLACE:
    each live row gets ``table[id] + row`` once, as the reference's
    ``table.at[ids].add`` in drop mode.  The padding is dropped on the
    device, with no host sync: padding slots repeat the last live slot's
    write (``dedup.live_slots``).  Returns ``table``."""
    ids = updates["ids"]
    n_live = (ids.to(torch.int64) < table.shape[0]).sum()
    slot, target = dedup.live_slots(ids, n_live)
    rows = updates["rows"].to(table.dtype)
    return table.index_copy_(0, target, table[target] + rows[slot])


def momentum_sparse_rows(spec: cs.SketchSpec, M, ids: torch.Tensor,
                         g: torch.Tensor, step, *, lr: Schedule,
                         gamma: float = 0.9, strict_paper: bool = False):
    """Sketched momentum (paper Alg. 2) on ``k`` unique rows: ``(M',
    row_updates)``, M updated IN PLACE."""
    eta = _eta(lr, step)
    m_old = cs.query(spec, M, ids)
    write = cs.query_after_update if strict_paper else cs.update_and_query
    M, m_new = write(spec, M, ids, (gamma - 1.0) * m_old + g)
    return M, -eta * m_new


def linear_decay(base_lr: float, total_steps: int,
                 floor: float = 0.0) -> Schedule:
    """``base_lr`` falling linearly to ``floor`` over ``total_steps``, in
    float32 over the host step counter."""
    def sched(step):
        t = torch.as_tensor(step).to(torch.float32)
        frac = torch.clamp(true_div(t, float(total_steps)), 0.0, 1.0)
        return base_lr * (1.0 - frac) + floor * frac
    return sched


def state_bytes(state) -> int:
    """Total bytes of optimizer state (the paper's Tables 5/6):
    ``stores.tree_bytes``."""
    return tree_bytes(state)
