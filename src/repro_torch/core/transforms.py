"""Composable gradient transforms for the sparse-rows path.

Counterpart of ``repro.core.transforms`` for ``chain``, ``scale_by_lr``
and ``scale_by_adam_rows``.  Each transform is a ``Transform(init,
update)`` pair with ``update(updates, state, params) -> (updates,
state)``; ``scale_by_adam_rows`` emits the unscaled ascent direction and
``scale_by_lr`` multiplies by ``-η(step)`` at the end of the chain.

The step counter is an int32 tensor on the host: it drives the host-side
schedule (learning rate, bias corrections, cleaning) without waiting for
the device.  Sketch states live on the transform's ``device`` and are
updated in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import kernels

Schedule = Union[float, Callable[[torch.Tensor], Any]]


class Transform(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)


def _lr_at(lr: Schedule, step) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _host_step() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def chain(*transforms) -> Transform:
    """Compose transforms left to right; the state is the tuple of their
    states."""

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

        def leaf(u):
            if isinstance(u, dict):
                return {k: leaf(v) for k, v in u.items()}
            if u is None or not u.is_floating_point():
                return u
            return neg_eta * u

        return leaf(updates), {"step": step}

    return Transform(init, update)


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
