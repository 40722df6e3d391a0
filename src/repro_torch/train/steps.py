"""Train step for one embedding/softmax table fed (ids, grad-rows).

Counterpart of the sparse-embedding part of ``repro.train.steps``, single
device only: data parallelism and sharded sketches wait for ROADMAP A13.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import optimizers as opt_lib
from repro_torch.core.cleaning import CleaningSchedule
from repro_torch.core.optimizers import SketchHParams


def resolve_sparse_stores(stores, path: str, shape: Tuple[int, int]):
    """Resolve a ``StoreTree`` at ``path`` for one (n, d) table.  Returns
    ``(m_store, v_store, track_first_moment)``: the 2nd moment must be
    sketch-backed, the 1st a signed count-sketch or absent (β₁=0)."""
    m_store, v_store = stores.resolve(path, shape, torch.float32)
    if v_store is None or v_store.kind not in ("countmin", "sketch"):
        raise ValueError(
            f"the sparse-rows pipeline needs a sketch-backed v store at "
            f"{path!r}; the StoreTree resolved "
            f"{None if v_store is None else v_store.kind!r}")
    if m_store is not None and m_store.kind != "sketch":
        raise ValueError(
            f"the sparse-rows kernels keep the 1st moment in a signed "
            f"count-sketch or drop it (β₁=0); the StoreTree resolved a "
            f"{m_store.kind!r} m store at {path!r}")
    return m_store, v_store, m_store is not None


def sparse_embedding_stores(n_rows: int, dim: int, *,
                            hparams: Optional[SketchHParams] = None,
                            track_first_moment: bool = True,
                            cleaning: Optional[CleaningSchedule] = None,
                            path: str = "sparse_embedding", stores=None):
    """The (m_store, v_store) pair ``make_sparse_embedding_step`` binds
    for the same table arguments."""
    hp = hparams if hparams is not None else SketchHParams()
    m_store = v_store = None
    if stores is not None:
        m_store, v_store, track_first_moment = resolve_sparse_stores(
            stores, path, (n_rows, dim))
    return opt_lib.sparse_rows_stores(
        (int(n_rows), int(dim)), path, hp,
        track_first_moment=track_first_moment, cleaning=cleaning,
        m_store=m_store, v_store=v_store)


def make_sparse_embedding_step(n_rows: int, dim: int, *, lr=1e-3,
                               b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8,
                               hparams: Optional[SketchHParams] = None,
                               track_first_moment: bool = True,
                               cleaning: Optional[CleaningSchedule] = None,
                               path: str = "sparse_embedding",
                               stores=None,
                               dp_axis: Optional[str] = None,
                               sketch_shards: int = 1,
                               device="cuda"):
    """Train step for the (ids, grad-rows) regime, where per-step work is
    O(touched rows).  Returns ``(init_fn, step_fn, optimizer)``:

        table     = init_fn(generator)             # (n_rows, dim) f32
        opt_state = optimizer.init()
        table', opt_state' = step_fn(table, opt_state, ids, grad_rows)

    ``step_fn`` updates the table and the sketches IN PLACE.  The
    optimizer is ``sparse_rows_adam``, routed through the backend named by
    ``hparams.backend`` ('auto': the CUDA kernel pipeline ``tiled`` on a
    card, plain ``xla`` on the CPU).  ``init_fn`` draws from a
    ``torch.Generator``, so its numbers differ from the reference's
    ``jax.random.normal``; start both packages from one state with
    ``repro_torch.convert.from_jax_state``."""
    if dp_axis is not None or sketch_shards > 1:
        raise NotImplementedError(
            "data-parallel and sharded sketch steps are not ported yet "
            "(ROADMAP A13); the port runs the single-device step")
    hp = hparams if hparams is not None else SketchHParams()
    m_store = v_store = None
    if stores is not None:
        # the tree's moment layout is authoritative
        m_store, v_store, track_first_moment = resolve_sparse_stores(
            stores, path, (n_rows, dim))
    opt = opt_lib.sparse_rows_adam(
        lr, b1=b1, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
        hparams=hp, track_first_moment=track_first_moment,
        cleaning=cleaning, m_store=m_store, v_store=v_store, device=device)

    def init_fn(generator: torch.Generator) -> torch.Tensor:
        scale = 1.0 / torch.sqrt(torch.tensor(dim, dtype=torch.float32))
        table = torch.randn((n_rows, dim), generator=generator,
                            dtype=torch.float32, device=device)
        return table * scale.to(device)

    first_only = opt_lib.first_occurrence_only(hp, v_store, device)

    def step_fn(table, opt_state, ids, grad_rows):
        updates, opt_state = opt.update(
            {"ids": ids, "rows": grad_rows}, opt_state)
        return opt_lib.apply_sparse_updates(
            table, updates, first_only=first_only), opt_state

    return init_fn, step_fn, opt
