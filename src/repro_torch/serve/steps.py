"""Serve-time sparse adaptation of an embedding table.

Counterpart of the single-device branch of
``repro.serve.steps.make_online_adapt_step``: the β₁=0 CS-Adam of the
training path (no first moment), its 2nd moment in a Count-Min sketch,
through the same kernel backends.  Replicated fleets (``dp_axis``) wait
for ROADMAP A13.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import optimizers as opt_lib
from repro_torch.core.optimizers import SketchHParams


def make_online_adapt_step(n_rows: int, dim: int, *, lr=1e-4,
                           b2: float = 0.999, eps: float = 1e-8,
                           hparams: Optional[SketchHParams] = None,
                           path: str = "serve_adapt",
                           v_store=None,
                           store_backend: Optional[str] = None,
                           dp_axis: Optional[str] = None,
                           device="cuda"):
    """Returns ``(init_state_fn, adapt_fn)``:

        opt_state          = init_state_fn()
        table', opt_state' = adapt_fn(table, opt_state, ids, grad_rows)

    ``adapt_fn`` updates the table and the sketch IN PLACE.
    ``store_backend`` pins the kernel backend, overriding both
    ``hparams.backend`` and the backend ``v_store`` carries."""
    if dp_axis is not None:
        raise NotImplementedError(
            "replicated serving (dp_axis) is not ported yet (ROADMAP A13)")
    hp = hparams if hparams is not None else SketchHParams()
    if store_backend is not None:
        hp = dataclasses.replace(hp, backend=store_backend)
        if v_store is not None:
            v_store = dataclasses.replace(v_store, backend=store_backend)
    opt = opt_lib.sparse_rows_adam(
        lr, b2=b2, eps=eps, shape=(n_rows, dim), path=path, hparams=hp,
        track_first_moment=False, v_store=v_store, device=device)

    def init_state_fn():
        return opt.init()

    first_only = opt_lib.first_occurrence_only(hp, v_store, device)

    def adapt_fn(table, opt_state, ids, grad_rows):
        updates, opt_state = opt.update(
            {"ids": ids, "rows": grad_rows}, opt_state)
        return opt_lib.apply_sparse_updates(
            table, updates, first_only=first_only), opt_state

    return init_state_fn, adapt_fn
