"""Composable gradient transforms: ``chain(clip_by_global_norm(0.1),
scale_by_adam(m_store=..., v_store=...), scale_by_lr(sched))``.

Counterpart of ``repro.core.transforms``.  Each transform is a
``Transform(init, update)`` pair with ``update(updates, state, params) ->
(updates, state)``; the ``scale_by_*`` rules emit the unscaled ascent
direction and ``scale_by_lr`` multiplies by ``-η(step)`` at the end of
the chain.  Parameter trees are nested dicts (or lists/tuples) of
tensors; paths are the reference's ('tok_embed/table').

The rules are written against the ``AuxStore`` protocol
(``repro_torch.core.stores``), so one rule runs over a dense buffer, a
Count-Sketch or a Count-Min, whatever the ``StoreTree`` resolves per
leaf.  A store pinned to a kernel backend takes the whole table through
one fused ``update_read`` per moment (on a card, B3); an unpinned one
runs the composed form over row chunks of ``dense_chunk``.

The step counter is an int32 tensor on the host: it drives the
host-side schedule (learning rate, bias corrections, cleaning, the
rounding seed of bf16/int8 sketch cells) without waiting for the
device.  Moment states live on their parameter's device
and are updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import kernels
from repro_torch.core import sketch as cs
from repro_torch.core.partition import leaf_paths
from repro_torch.core.quantize import QuantState
from repro_torch.core.stores import DenseStore, Rank1Moment, StoreTree
from repro_torch.kernels.ops import bias_correction
from repro_torch.kernels.ref import true_div

Schedule = Union[float, Callable[[torch.Tensor], Any]]


class Transform(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)


def _lr_at(lr: Schedule, step) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _host_step() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def tree_map_with_path(fn, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree``, a
    nested dict/list/tuple; the ``rest`` trees are indexed at the same
    keys (a None there is passed as the leaf).  Dict keys are visited
    sorted, as ``jax.tree_util`` visits them; None in ``tree`` is an
    empty subtree and stays None, and a ``QuantState`` (one int8 sketch
    state) or a ``Rank1Moment`` (one rank-1 state) is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(
                    fn, tree[k], *[None if r is None else r[k] for r in rest],
                    prefix=f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) \
            and not isinstance(tree, (QuantState, Rank1Moment)):
        return type(tree)(tree_map_with_path(
            fn, v, *[None if r is None else r[i] for r in rest],
            prefix=f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def _unzip(like, pairs, n: int):
    """Split a tree of n-tuples, shaped like ``like``, into n trees."""
    return tuple(tree_map_with_path(lambda _p, _x, t: t[i], like, pairs)
                 for i in range(n))


def chain(*transforms) -> Transform:
    """Compose transforms left to right; the state is the tuple of their
    states.  Anything with ``init``/``update`` composes."""

    def init(params=None):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def scale_by_lr(lr: Schedule) -> Transform:
    """Multiply float updates by ``-η(step)``; integer leaves (the ``ids``
    of a rows gradient) and None pass through."""

    def init(params=None):
        return {"step": _host_step()}

    def update(updates, state, params=None):
        step = state["step"] + 1
        neg_eta = -_lr_at(lr, step)

        def leaf(_path, u):
            return u if not u.is_floating_point() else neg_eta * u

        return tree_map_with_path(leaf, updates), {"step": step}

    return Transform(init, update)


class ClipByGlobalNorm:
    """Scale updates so their global L2 norm is at most ``max_norm`` (the
    paper clips at 0.1-1.0).  A chain link, and a callable on a gradient
    tree."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def __call__(self, grads):
        leaves = [g for _path, g in leaf_paths(grads)]
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                            for g in leaves))
        # a tensor numerator keeps true division on the card
        scale = torch.clamp(torch.full_like(gn, self.max_norm)
                            / (gn + 1e-12), max=1.0)
        return tree_map_with_path(lambda _p, g: g * scale.to(g.dtype), grads)

    def init(self, params=None):
        return {}

    def update(self, updates, state, params=None):
        return self(updates), state


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(max_norm)


# ---------------------------------------------------------------------------
# Shared leaf plumbing
# ---------------------------------------------------------------------------

def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is at most target."""
    if target <= 0 or n <= target:
        return n
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


def _row_active(g: torch.Tensor) -> torch.Tensor:
    """1.0 for rows with any non-zero gradient, else 0.0 (lazy updates)."""
    return (g != 0).any(dim=-1, keepdim=True).to(torch.float32)


def _sketched_rows_scan(g, carry, step_chunk, chunk: int, extra=None):
    """Run ``step_chunk(carry, ids, g_chunk, [extra_chunk]) -> (carry, u)``
    over row chunks of the dense gradient ``g`` (n, d), in order; ``extra``
    is a second (n, d) tensor chunked alongside.  Returns ``(carry, u)``
    with the chunks' ``u`` joined."""
    n = g.shape[0]
    chunk = _pick_chunk(n, chunk)
    ids = torch.arange(n, dtype=torch.int32, device=g.device)
    outs = []
    for lo in range(0, n, chunk):
        part = slice(lo, lo + chunk)
        xs = (ids[part], g[part]) + (() if extra is None else (extra[part],))
        carry, u = step_chunk(carry, *xs)
        outs.append(u)
    return carry, torch.cat(outs)


def _fused(store) -> bool:
    """True when the store's ``update_read`` runs as one fused op (a kernel
    backend is pinned): the transform then hands it the whole table."""
    return store is not None and getattr(store, "backend", None) is not None


def _bias_corrections(step, b1: float, b2: float):
    t = int(step)
    return bias_correction(b1, t), bias_correction(b2, t)


# ---------------------------------------------------------------------------
# scale_by_momentum (paper Alg. 2)
# ---------------------------------------------------------------------------

def scale_by_momentum(gamma: float = 0.9, *,
                      stores: Optional[StoreTree] = None, m_store=None,
                      where=None, dense_chunk: int = 8192, lazy: bool = True,
                      strict_paper: bool = False) -> Transform:
    """Polyak momentum ``m <- γm + g``; emits ``m``.  ``DenseStore`` runs
    the closed form, ``CountSketchStore`` the paper's linear form
    ``Δ = (γ-1)·m̂ + g``."""
    if stores is None:
        stores = StoreTree.select(m=m_store if m_store is not None
                                  else DenseStore(), v=None, where=where,
                                  default_v=None)

    def _m(path, leaf):
        m, _ = stores.resolve(path, tuple(leaf.shape), leaf.dtype)
        if m is None or m.kind not in ("dense", "sketch"):
            raise ValueError(f"scale_by_momentum needs a dense or signed "
                             f"count-sketch m store at {path!r}, got "
                             f"{None if m is None else m.kind}")
        return m

    def init(params):
        return {"step": _host_step(),
                "m": tree_map_with_path(
                    lambda p, leaf: _m(p, leaf).init(leaf.device), params)}

    def update(grads, state, params=None):
        step = state["step"] + 1

        def leaf(path, g, M):
            ms = _m(path, g)
            if ms.kind == "dense":
                m_new, _ = ms.update_read(M, g, gamma, scale=1.0)
                return m_new, m_new
            act = _row_active(g) if lazy else 1.0
            mask = act if lazy else None
            if _fused(ms) and not strict_paper:
                M_out, m_est = ms.update_read(M, g, gamma, scale=1.0,
                                              mask=mask, step=step)
                return M_out, act * m_est
            if dense_chunk and not strict_paper:
                # estimates read the pre-step sketch while the chunks add
                # into M in place: read them off a snapshot
                pre = cs.clone(M)

                def chunk_step(carry, ids, gc):
                    a = _row_active(gc) if lazy else 1.0
                    carry, m_est = ms.update_read(
                        carry, gc, gamma, scale=1.0, rows=ids,
                        mask=a if lazy else None, read_state=pre,
                        step=step)
                    return carry, a * m_est
                return _sketched_rows_scan(g, M, chunk_step, dense_chunk)
            M_out, m_est = ms.update_read(M, g, gamma, scale=1.0, mask=mask,
                                          strict=strict_paper, step=step)
            return M_out, act * m_est

        m, updates = _unzip(grads, tree_map_with_path(leaf, grads,
                                                      state["m"]), 2)
        return updates, {"step": step, "m": m}

    return Transform(init, update)


# ---------------------------------------------------------------------------
# scale_by_adagrad (paper Alg. 3)
# ---------------------------------------------------------------------------

def scale_by_adagrad(eps: float = 1e-10, *,
                     stores: Optional[StoreTree] = None, v_store=None,
                     where=None, dense_chunk: int = 8192,
                     strict_paper: bool = False) -> Transform:
    """Adagrad ``v <- v + g²``; emits ``g / (√v + ε)``, the squared
    gradient in a ``DenseStore`` or a ``CountMinStore`` (paper Alg. 3)."""
    if stores is None:
        stores = StoreTree.select(v=v_store if v_store is not None
                                  else DenseStore(), m=None, where=where,
                                  default_m=None)

    def _v(path, leaf):
        _, v = stores.resolve(path, tuple(leaf.shape), leaf.dtype)
        if v is None or v.kind not in ("dense", "countmin"):
            raise ValueError(f"scale_by_adagrad needs a dense or count-min "
                             f"v store at {path!r}, got "
                             f"{None if v is None else v.kind}")
        return v

    def init(params):
        return {"step": _host_step(),
                "v": tree_map_with_path(
                    lambda p, leaf: _v(p, leaf).init(leaf.device), params)}

    def update(grads, state, params=None):
        step = state["step"] + 1

        def leaf(path, g, V):
            vs = _v(path, g)
            if vs.kind == "dense":
                v_new, _ = vs.update_read(V, g * g, 1.0, scale=1.0)
                return v_new, g / (torch.sqrt(v_new) + eps)
            V_in = vs.clean(V, step)
            if _fused(vs) and not strict_paper:
                V_out, v_est = vs.update_read(V_in, g * g, 1.0, scale=1.0,
                                              step=step)
                return V_out, g / (torch.sqrt(torch.clamp_min(v_est, 0.0))
                                   + eps)
            if dense_chunk and not strict_paper:
                pre = cs.clone(V_in)

                def chunk_step(carry, ids, gc):
                    carry, v_est = vs.update_read(carry, gc * gc, 1.0,
                                                  scale=1.0, rows=ids,
                                                  read_state=pre, step=step)
                    v_new = torch.clamp_min(v_est, 0.0)
                    return carry, gc / (torch.sqrt(v_new) + eps)
                return _sketched_rows_scan(g, V_in, chunk_step, dense_chunk)
            V_out, v_est = vs.update_read(V_in, g * g, 1.0, scale=1.0,
                                          strict=strict_paper, step=step)
            return V_out, g / (torch.sqrt(torch.clamp_min(v_est, 0.0)) + eps)

        v, updates = _unzip(grads, tree_map_with_path(leaf, grads,
                                                      state["v"]), 2)
        return updates, {"step": step, "v": v}

    return Transform(init, update)


# ---------------------------------------------------------------------------
# scale_by_adam (paper Alg. 4): the store-parameterized core
# ---------------------------------------------------------------------------

_UNSET = object()


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                  stores: Optional[StoreTree] = None,
                  m_store: Any = _UNSET, v_store: Any = _UNSET,
                  where=None, dense_chunk: int = 8192, lazy: bool = True,
                  strict_paper: bool = False) -> Transform:
    """Adam whose moments live wherever the ``StoreTree`` says: per leaf,
    the 1st moment in a ``DenseStore``, a ``CountSketchStore`` or nowhere
    (None: β₁=0 for that leaf), the 2nd in a ``DenseStore``, a
    ``CountMinStore`` (optional cleaning), a ``CountSketchStore`` or a
    ``Rank1Store`` (LR-NMF-V).  Emits ``m̂ / (√v̂ + ε)``.

    ``m_store``/``v_store`` + ``where`` is sugar for a two-level tree:
    selected leaves get those stores, the rest stay dense.  ``lazy``:
    rows whose gradient is all zero get no update and no sketch write.
    ``strict_paper``: the 3-pass form that re-queries after the update.
    ``dense_chunk``: row chunk of the composed (unpinned) form."""
    if stores is None:
        stores = StoreTree.select(
            m=DenseStore() if m_store is _UNSET else m_store,
            v=DenseStore() if v_store is _UNSET else v_store,
            where=where)

    def _mv(path, leaf):
        ms, vs = stores.resolve(path, tuple(leaf.shape), leaf.dtype)
        if vs is None:
            raise ValueError(f"scale_by_adam needs a v store at {path!r}")
        if vs.kind not in ("dense", "countmin", "sketch", "rank1"):
            raise ValueError(f"unsupported v store kind {vs.kind!r} at "
                             f"{path!r} (dense | countmin | sketch | rank1)")
        if ms is not None and ms.kind not in ("dense", "sketch"):
            raise ValueError(f"unsupported m store kind {ms.kind!r} at "
                             f"{path!r} (dense | sketch | None)")
        if vs.kind == "dense" and ms is not None and ms.kind == "sketch":
            raise ValueError(f"sketched m over dense v at {path!r} is not "
                             f"a paper layout (sketch the 2nd moment too)")
        return ms, vs

    def init(params):
        def m_leaf(path, p):
            ms, _ = _mv(path, p)
            return ms.init(p.device) if ms is not None else None

        def v_leaf(path, p):
            return _mv(path, p)[1].init(p.device)

        return {"step": _host_step(),
                "m": tree_map_with_path(m_leaf, params),
                "v": tree_map_with_path(v_leaf, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        bc1, bc2 = _bias_corrections(step, b1, b2)

        def leaf(path, g, M, V):
            ms, vs = _mv(path, g)
            if vs.kind == "rank1":
                # LR-NMF-V: decay, mean-accumulate and read through the
                # store (lowrank.nmf_rank1_adam's numbers), dense or no m
                g2 = torch.square(g.to(torch.float32))
                V_out, vhat = vs.update_read(V, g2, b2, scale=1.0 - b2)
                if ms is not None:
                    M_out, m_new = ms.update_read(M, g, b1)
                    mhat = true_div(m_new, bc1)
                else:
                    M_out, mhat = None, g
                return M_out, V_out, mhat / (torch.sqrt(torch.clamp_min(
                    true_div(vhat, bc2), 0.0)) + eps)
            if vs.kind == "dense":
                # the v delta is pre-scaled ((1-β₂)·g)·g, the reference's
                # association on dense leaves
                if ms is None:
                    mhat, M_out = g, None
                else:
                    M_out, m_new = ms.update_read(M, g, b1)
                    mhat = true_div(m_new, bc1)
                v_new, _ = vs.update_read(V, (1.0 - b2) * g * g, b2,
                                          scale=1.0)
                return M_out, v_new, mhat / (
                    torch.sqrt(true_div(v_new, bc2)) + eps)

            # sketched 2nd moment (count-min, or signed count-sketch)
            sketched_m = ms is not None and ms.kind == "sketch"
            V_in = vs.clean(V, step)
            # dense 1st moment beside a sketched 2nd (the paper's CS-V)
            if ms is not None and not sketched_m:
                M_out, m_dense = ms.update_read(M, g, b1)
                mhat_rows = true_div(m_dense, bc1)
            else:
                M_out, mhat_rows = None, None

            fused = (not strict_paper and _fused(vs)
                     and (not sketched_m or _fused(ms)))
            if not fused and dense_chunk and not strict_paper:
                # composed form over row chunks; every estimate reads the
                # pre-step sketches, snapshotted because the chunks add
                # into M and V in place
                M_pre = cs.clone(M) if sketched_m else None
                V_pre = cs.clone(V_in)

                def chunk_step(carry, ids, gc, *mh_c):
                    a = _row_active(gc) if lazy else 1.0
                    mk = a if lazy else None
                    if sketched_m:
                        carry["M"], m_est = ms.update_read(
                            carry["M"], gc, b1, rows=ids, mask=mk,
                            read_state=M_pre, step=step)
                        mh = true_div(m_est, bc1)
                    elif ms is not None:
                        mh = mh_c[0]
                    else:
                        mh = gc
                    carry["V"], v_est = vs.update_read(
                        carry["V"], gc * gc, b2, rows=ids, mask=mk,
                        read_state=V_pre, step=step)
                    vh = true_div(torch.clamp_min(v_est, 0.0), bc2)
                    return carry, a * mh / (torch.sqrt(vh) + eps)

                carry0 = {"V": V_in, "M": M if sketched_m else None}
                carry, upd = _sketched_rows_scan(
                    g, carry0, chunk_step, dense_chunk, extra=mhat_rows)
                return (carry["M"] if sketched_m else M_out), carry["V"], upd

            # one fused op per moment over the whole table (a pinned
            # backend), or the unchunked composed form (also strict_paper)
            act = _row_active(g) if lazy else 1.0
            mask = act if lazy else None
            if sketched_m:
                M_out, m_est = ms.update_read(M, g, b1, mask=mask,
                                              strict=strict_paper, step=step)
                mhat = true_div(m_est, bc1)
            elif ms is not None:
                mhat = mhat_rows
            else:
                mhat = g
            V_out, v_est = vs.update_read(V_in, g * g, b2, mask=mask,
                                          strict=strict_paper, step=step)
            vh = true_div(torch.clamp_min(v_est, 0.0), bc2)
            return M_out, V_out, act * mhat / (torch.sqrt(vh) + eps)

        m, v, dirs = _unzip(grads, tree_map_with_path(
            leaf, grads, state["m"], state["v"]), 3)
        return dirs, {"step": step, "m": m, "v": v}

    return Transform(init, update)


def scale_by_rmsprop(b2: float = 0.999, eps: float = 1e-8, *,
                     stores: Optional[StoreTree] = None,
                     v_store: Any = _UNSET, where=None,
                     dense_chunk: int = 8192, lazy: bool = True,
                     strict_paper: bool = False) -> Transform:
    """The β₁=0 rule of Theorem 5.1: ``scale_by_adam`` with every m slot
    forced to None."""
    if stores is None:
        stores = StoreTree.select(
            m=None, v=DenseStore() if v_store is _UNSET else v_store,
            where=where, default_m=None)
    return scale_by_adam(b1=0.0, b2=b2, eps=eps,
                         stores=stores.without_first_moment(),
                         dense_chunk=dense_chunk, lazy=lazy,
                         strict_paper=strict_paper)


def scale_by_adam_rows(b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, *, m_store, v_store,
                       backend: Optional[str] = None,
                       device="cuda") -> Transform:
    """Adam for ONE table fed ``{"ids": (k,), "rows": (k, d)}`` gradients.

    ``m_store`` (``CountSketchStore``, or None for β₁=0) and ``v_store``
    (``CountMinStore``, cleaning honoured) must be bound; the step runs
    through the kernel backend registry (``repro_torch.kernels``).
    Emits ``{"ids", "rows": direction}``, the direction unscaled; compose
    with ``scale_by_lr`` and apply with ``apply_sparse_updates``."""
    for name, store, kinds in (("m_store", m_store, ("sketch",)),
                               ("v_store", v_store, ("countmin", "sketch"))):
        if store is None:
            continue
        if store.kind not in kinds or store.spec is None:
            raise ValueError(f"{name} must be a bound (explicit-spec) "
                             f"{'/'.join(kinds)} store, got {store!r}")
    spec_m = m_store.spec if m_store is not None else None
    spec_v = v_store.spec

    def init(params=None):
        return {"step": _host_step(),
                "m": m_store.init(device) if m_store is not None else None,
                "v": v_store.init(device)}

    def update(grads, state, params=None):
        ids, rows = grads["ids"], grads["rows"]
        step = state["step"] + 1
        V_in = v_store.clean(state["v"], step)
        # lr=-1.0 makes the kernels emit the raw ascent direction (an
        # exact ±1 multiply), leaving the descent scale to scale_by_lr
        M, V, direction = kernels.adam_rows(
            spec_m, spec_v, state["m"], V_in, ids, rows, step,
            lr=-1.0, b1=b1, b2=b2, eps=eps, backend=backend)
        return ({"ids": ids, "rows": direction},
                {"step": step, "m": M, "v": V})

    return Transform(init, update)


def scale_by_adam_rows_dp(b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, *, m_store, v_store,
                          axis_name="data", error_feedback: bool = False,
                          dir_clip: Optional[float] = 10.0,
                          device="cuda") -> Transform:
    """Data-parallel ``scale_by_adam_rows``: the same one-table (ids, rows)
    contract, but each replica of ``axis_name`` (a ``dp_axis`` of
    ``repro_torch.distributed.collectives``) calls ``update`` with its own
    gradient shard and its own copy of the replicated state.  The
    collectives move the (depth, width, dim) sketches and the int32 ids,
    never the (k, d) rows (``distributed.sketched_reduce.dp_adam_rows``).
    ``error_feedback`` adds the residual sketch of the 2nd moment's
    cross-replica term (state key ``"residual"``, None without it).

    Emits ``{"ids": global unique ids, "rows": direction}``, the direction
    unscaled; compose with ``scale_by_lr`` and apply with
    ``optimizers.apply_unique_updates`` (the padding ids are out of
    range).  ``dir_clip``: the trust clamp on the direction (None
    disables)."""
    for name, store, kinds in (("m_store", m_store, ("sketch",)),
                               ("v_store", v_store, ("countmin", "sketch"))):
        if store is None:
            continue
        if store.kind not in kinds or store.spec is None:
            raise ValueError(f"{name} must be a bound (explicit-spec) "
                             f"{'/'.join(kinds)} store, got {store!r}")
    spec_m = m_store.spec if m_store is not None else None
    spec_v = v_store.spec

    def init(params=None):
        from repro_torch.distributed import sketched_reduce as sr
        return {"step": _host_step(),
                "m": m_store.init(device) if m_store is not None else None,
                "v": v_store.init(device),
                "residual": (sr.init_feedback(spec_v, device)
                             if error_feedback else None)}

    def update(grads, state, params=None):
        from repro_torch.distributed import sketched_reduce as sr
        step = state["step"] + 1
        V_in = v_store.clean(state["v"], step)
        out = sr.dp_adam_rows(
            spec_m, spec_v, state["m"], V_in, grads["ids"], grads["rows"],
            step, axis_name=axis_name, b1=b1, b2=b2, eps=eps,
            residual=state["residual"], dir_clip=dir_clip)
        return ({"ids": out.uids, "rows": out.rows},
                {"step": step, "m": out.M, "v": out.V,
                 "residual": out.residual})

    return Transform(init, update)


def scale_by_adam_rows_sharded(b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8, *, m_store, v_store,
                               shard_axis="model", dp_axis=None,
                               error_feedback: bool = False,
                               dir_clip: Optional[float] = 10.0,
                               backend: Optional[str] = None,
                               device="cuda") -> Transform:
    """``scale_by_adam_rows_dp`` with the sketch state sharded over
    ``shard_axis`` into width slabs: the stores' specs must declare
    ``shards > 1`` (``with_sharding`` or the planner's
    ``sketch_shards``), and each replica of the (dp × shard) grid calls
    ``update`` with its own (depth, local_width, dim) slab of every
    rank-3 state leaf (``distributed.slabs.shard_state``) and its dp
    shard of the batch (``distributed.sketched_reduce.
    sharded_adam_rows``).  ``init`` returns FULL (depth, width, dim)
    tensors, as the reference's does: sharding is placement.
    ``dp_axis`` None is the shard-only grid."""
    for name, store, kinds in (("m_store", m_store, ("sketch",)),
                               ("v_store", v_store, ("countmin", "sketch"))):
        if store is None:
            continue
        if store.kind not in kinds or store.spec is None:
            raise ValueError(f"{name} must be a bound (explicit-spec) "
                             f"{'/'.join(kinds)} store, got {store!r}")
        if store.spec.shards < 2:
            raise ValueError(f"{name} is not sharded (spec.shards == "
                             f"{store.spec.shards}); use "
                             f"scale_by_adam_rows_dp for replicated state "
                             f"or with_sharding() the store")
    spec_m = m_store.spec if m_store is not None else None
    spec_v = v_store.spec
    if spec_m is not None and (spec_m.shards != spec_v.shards
                               or spec_m.layout != spec_v.layout):
        raise ValueError(f"m/v stores disagree on the shard layout: "
                         f"{spec_m.shards}×{spec_m.layout!r} vs "
                         f"{spec_v.shards}×{spec_v.layout!r}")

    def init(params=None):
        from repro_torch.distributed import sketched_reduce as sr
        return {"step": _host_step(),
                "m": m_store.init(device) if m_store is not None else None,
                "v": v_store.init(device),
                "residual": (sr.init_feedback(spec_v, device)
                             if error_feedback else None)}

    def update(grads, state, params=None):
        from repro_torch.distributed import sketched_reduce as sr
        step = state["step"] + 1
        V_in = v_store.clean(state["v"], step)      # a decay: slab-safe
        out = sr.sharded_adam_rows(
            spec_m, spec_v, state["m"], V_in, grads["ids"], grads["rows"],
            step, shard_axis=shard_axis, dp_axis=dp_axis, b1=b1, b2=b2,
            eps=eps, residual=state["residual"], dir_clip=dir_clip,
            backend=backend)
        return ({"ids": out.uids, "rows": out.rows},
                {"step": step, "m": out.M, "v": out.V,
                 "residual": out.residual})

    return Transform(init, update)
