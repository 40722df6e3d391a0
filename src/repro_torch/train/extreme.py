"""Extreme-classification workload: MACH + sampled softmax at table scale.

Counterpart of ``repro.train.extreme``.  The paper's
headline systems result (§7.3, Table 8) trains a 49.5M-class task with
the β₁=0 Count-Min optimizer of Theorem 5.1 and spends the freed
optimizer memory on a larger batch.  The step here builds that regime on
the port's sparse-rows path:

  * **MACH** (``core.hashing.mach_class_hash``): ``n_replicas``
    independent meta-classifiers, each mapping the ``n_classes`` true
    labels into an ``n_meta``-row output table; ``MetaStream`` applies a
    replica's map to a batch on the host;
  * **sampled softmax**: each example scores its positive meta-class
    against ``n_negatives`` shared candidates, so the loss touches
    O(B·nnz + B + n_negatives) table rows.  Autograd runs on the gathered
    rows only, never on the tables, and the gradients arrive as (ids,
    rows), duplicate ids merged by ``kernels/dedup.py``;
  * **optimizer**: ``sparse_rows_adam`` for ``cs_rmsprop`` (β₁=0) and
    ``cs_adam`` (on a card: dedup + B1 ``cs_adam_tiled``), sized by
    ``SketchHParams`` or by a memory plan (``plan_extreme``, the
    planner's water-fill over both tables), or ``dense_rows_adam``, the
    memory-limited baseline in the same (ids, rows) calling convention.

Tables and states are updated IN PLACE.  With ``dp_axis`` the step is
one replica of a data-parallel axis (``sparse_rows_adam_dp``), named
on a collectives ``mesh`` when one is given.  ``python -m
repro_torch.launch.train --workload extreme`` drives it, one replica
after the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import optimizers as opt_lib
from repro_torch.core.hashing import mach_class_hash
from repro_torch.core.optimizers import SketchHParams, _with_lr
from repro_torch.core.transforms import Transform, _host_step
from repro_torch.data import ExtremeConfig
from repro_torch.distributed.collectives import as_axis, mesh_axis
from repro_torch.kernels import dedup
from repro_torch.kernels.ops import bias_correction
from repro_torch.kernels.ref import true_div
from repro_torch.obs.profiling import scope
from repro_torch.train.steps import resolve_sparse_stores

# optimizer modes the sparse-rows step can run: β₁=0 Count-Min (the
# paper's extreme-scale choice), CS-MV Adam, and the dense baseline
EXTREME_OPTIMIZERS = ("dense_adam", "cs_rmsprop", "cs_adam")

TABLE_PATHS = ("tok_embed/table", "class_head/table")


@dataclasses.dataclass(frozen=True)
class MachConfig:
    """The workload: true-label space, MACH reduction, feature space and
    the sampled-softmax candidate counts.  ``n_meta`` is the output table
    the optimizer state lives over; ``n_classes`` may be far larger."""

    n_classes: int
    n_meta: int
    n_features: int
    dim: int = 64
    n_replicas: int = 2
    nnz: int = 16
    n_negatives: int = 1024
    alpha: float = 1.05
    seed: int = 0

    def data_config(self, batch: int) -> ExtremeConfig:
        return ExtremeConfig(
            n_features=self.n_features, n_classes=self.n_classes,
            batch=batch, nnz=self.nnz, n_negatives=self.n_negatives,
            alpha=self.alpha, seed=self.seed)

    def table_shapes(self) -> Dict[str, Tuple[int, int]]:
        return {"tok_embed/table": (self.n_features, self.dim),
                "class_head/table": (self.n_meta, self.dim)}

    def class_maps(self) -> np.ndarray:
        """(n_replicas, n_classes) int32: replica r's true-label ->
        meta-class map (independent hash families per replica)."""
        return np.stack([
            mach_class_hash(seed=self.seed + 101 * r,
                            num_classes=self.n_classes,
                            num_buckets=self.n_meta, num_hashes=1)[0]
            for r in range(self.n_replicas)])


def plan_extreme(cfg: MachConfig, budget, *, optimizer: str = "cs_rmsprop",
                 backend: Optional[str] = None, depth: int = 3,
                 width_multiple: int = 256, seed: int = 0,
                 sketch_dtype: str = "float32"):
    """The aux-memory plan of the workload's two tables under ``budget``
    (bytes or a ``parse_budget`` string), both tables carrying the
    stream's zipf exponent as traffic stats, so the water-fill splits
    width by volume x traffic.  ``sketch_dtype`` sizes the plan at that
    cell dtype; ``backend`` pins the plan's kernel backend."""
    from repro_torch.plan import TableStats, plan_for_tables
    stats = {p: TableStats(alpha=cfg.alpha) for p in TABLE_PATHS}
    plan = plan_for_tables(cfg.table_shapes(), budget, optimizer=optimizer,
                           stats=stats, default_alpha=cfg.alpha, depth=depth,
                           width_multiple=width_multiple, seed=seed,
                           sketch_dtype=sketch_dtype)
    return plan.with_backend(backend) if backend else plan


class MetaStream:
    """One replica's batches: an ``ExtremeStream``'s true-label ids (labels
    and negatives) mapped through ``cmap`` (``class_maps()[r]``) on the
    host, then all three as int32 tensors on ``device``."""

    def __init__(self, stream, cmap: np.ndarray, device="cuda"):
        self.stream = stream
        self.cmap = cmap
        self.device = device

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.stream.batch(step)
        host = {"features": b["features"],
                "labels": self.cmap[b["labels"]],
                "negatives": self.cmap[b["negatives"]]}
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
            self.device) for k, v in host.items()}


def dense_rows_adam(lr, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, *, shape: Tuple[int, int],
                    device="cuda") -> Transform:
    """Dense Adam in the (ids, rows) calling convention, the baseline arm:
    full (n, d) m and v on ``device`` (the memory the sketch arm frees),
    but per-step work O(touched rows): duplicates merge through
    ``dedup_rows`` and only the unique rows' moments move, IN PLACE.  The
    ``{"step", "m", "v"}`` state layout and ``scale_by_lr`` terminal of
    ``sparse_rows_adam``.  Its updates carry each id's update at its first
    occurrence and zeros at later ones."""
    n, d = int(shape[0]), int(shape[1])

    def init(params=None):
        return {"step": _host_step(),
                "m": torch.zeros((n, d), dtype=torch.float32, device=device),
                "v": torch.zeros((n, d), dtype=torch.float32, device=device)}

    def update(grads, state, params=None):
        ids, rows = grads["ids"], grads["rows"]
        db = dedup.dedup_rows(ids, rows)
        live = db.mask[:, None]                     # (k, 1) f32
        # padding slots read and write the last live slot's row, so every
        # copy to a row writes the same bits (the reference clamps them
        # onto row 0 with a zero delta)
        slot, uids = dedup.live_slots(db.unique_ids, db.n_unique)
        g = db.rows
        step = state["step"] + 1
        t = int(step)
        m_old = state["m"][uids]
        v_old = state["v"][uids]
        dm = live * (1.0 - b1) * (g - m_old)
        dv = live * (1.0 - b2) * (g * g - v_old)
        m_new, v_new = m_old + dm, v_old + dv
        state["m"].index_copy_(0, uids, m_new[slot])
        state["v"].index_copy_(0, uids, v_new[slot])
        mhat = true_div(m_new, bias_correction(b1, t))
        vhat = true_div(torch.clamp_min(v_new, 0.0), bias_correction(b2, t))
        # raw ascent direction (lr=-1.0 convention); scale_by_lr flips it
        direction = live * mhat / (torch.sqrt(vhat) + eps)
        return ({"ids": ids, "rows": dedup.scatter_back(db, direction)},
                {"step": step, "m": state["m"], "v": state["v"]})

    return _with_lr(Transform(init, update), lr)


def mach_log_scores(logits_list, class_maps, candidates) -> np.ndarray:
    """MACH inference aggregation (paper §7.3): per-replica meta-class
    log-softmax summed over replicas at the candidate classes.

    ``logits_list``: per replica, (B, n_meta) raw meta logits;
    ``class_maps``: per replica, (n_classes,) label -> meta-class map;
    ``candidates``: (C,) candidate class ids.  Returns (B, C) scores."""
    agg = None
    for logits, cmap in zip(logits_list, class_maps):
        logits = np.asarray(logits, np.float64)
        mx = logits.max(axis=-1, keepdims=True)
        logz = mx + np.log(np.exp(logits - mx).sum(axis=-1, keepdims=True))
        logp = logits - logz                        # (B, n_meta)
        scores = logp[:, np.asarray(cmap)[np.asarray(candidates)]]
        agg = scores if agg is None else agg + scores
    return agg


def unique_id_ratio(ids: torch.Tensor) -> torch.Tensor:
    """Fraction of distinct ids in a gradient batch, a device scalar: the
    work the dedup pre-pass saves (``dedup_ratio`` in step metrics)."""
    s = torch.sort(ids.reshape(-1)).values
    n_unique = 1 + torch.sum((s[1:] != s[:-1]).to(torch.int32))
    return true_div(n_unique.to(torch.float32), float(s.shape[0]))


def _sampled_softmax_loss(emb_rows, pos_w, neg_w):
    """(B, nnz, d) gathered embedding rows + (B, d)/(neg, d) gathered head
    rows -> mean sampled-softmax NLL with the positive in slot 0."""
    emb = emb_rows.sum(dim=1)                                  # (B, d)
    pos = torch.sum(emb * pos_w, dim=-1)                       # (B,)
    neg = emb @ neg_w.T                                        # (B, neg)
    logits = torch.cat([pos[:, None], neg], dim=1)
    return torch.mean(torch.logsumexp(logits, dim=-1) - logits[:, 0])


def extreme_grads(params, batch):
    """``(loss, grads)`` of one step: the sampled-softmax loss (a device
    scalar) and, per table path, its gradient as ``{"ids", "rows"}``, one
    row per occurrence.  Autograd runs on leaves over the gathered rows,
    so no (n, d) gradient of a table is ever built."""
    feats = batch["features"].to(torch.int32)                  # (B, nnz)
    labels = batch["labels"].to(torch.int32)                   # (B,)
    negs = batch["negatives"].to(torch.int32)                  # (neg,)
    tok = params["tok_embed"]["table"]
    head = params["class_head"]["table"]
    leaves = (tok[feats.long()].detach().requires_grad_(),
              head[labels.long()].detach().requires_grad_(),
              head[negs.long()].detach().requires_grad_())
    with torch.enable_grad():
        loss = _sampled_softmax_loss(*leaves)
        g_emb, g_pos, g_neg = torch.autograd.grad(loss, leaves)
    return loss.detach(), {
        "tok_embed/table": {"ids": feats.reshape(-1),
                            "rows": g_emb.reshape(-1, tok.shape[1])},
        "class_head/table": {"ids": torch.cat([labels, negs]),
                             "rows": torch.cat([g_pos, g_neg])},
    }


def make_extreme_step(cfg: MachConfig, *, optimizer: str = "cs_rmsprop",
                      lr=1e-3, hparams: Optional[SketchHParams] = None,
                      plan=None, backend: Optional[str] = None,
                      dp_axis=None, mesh=None,
                      error_feedback: bool = False,
                      dir_clip: Optional[float] = 10.0, device="cuda"):
    """One MACH replica's train step over the (ids, rows) substrate.

    Returns ``(init_fn, step_fn, opts)``:

        params     = init_fn(generator)  # {"tok_embed"/"class_head": {"table"}}
        opt_state  = {path: opt.init() for path, opt in opts.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)

    ``batch``: ``features`` (B, nnz), ``labels`` (B,) and ``negatives``
    (n_negatives,) int32 tensors on ``device``, labels and negatives
    already mapped to meta-class ids (``MetaStream``).  ``step_fn``
    updates both tables and every state IN PLACE; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``dedup_ratio`` as device scalars.
    ``plan`` (a ``plan_extreme`` result, solved for this ``optimizer``)
    pins both tables' stores; otherwise ``hparams`` (default
    ``SketchHParams(compression=100.0)``) sizes them.  ``backend``
    overrides the kernel backend either way ('auto' when nothing names
    one: ``tiled`` on a card).  ``init_fn`` draws from a
    ``torch.Generator``; start from the reference's numbers with
    ``repro_torch.convert``.

    ``dp_axis``: each replica of that axis calls ``step_fn`` with its
    shard of ``features`` and ``labels`` and the same ``negatives``; the
    tables' gradients are reduced as sketches (``sparse_rows_adam_dp``
    with ``error_feedback`` and ``dir_clip``), the loss and
    ``dedup_ratio`` are ``pmean``'d and ``grad_norm`` is
    ``sqrt(psum(gn²))`` over the replicas' rows.  ``mesh``: a
    collectives mesh (``ReplicaMesh``, ``GroupMesh``) whose axis named
    ``dp_axis`` is the data-parallel axis, as the reference's ``shard_map``
    runs over the mesh's axis of that name."""
    if optimizer not in EXTREME_OPTIMIZERS:
        raise ValueError(
            f"extreme workload optimizers are {EXTREME_OPTIMIZERS}; "
            f"{optimizer!r} has no (ids, rows) form")
    dense = optimizer == "dense_adam"
    if dense:
        if plan is not None:
            raise ValueError("dense_adam is the no-plan baseline — a "
                             "memory plan under it would silently compress "
                             "the run it is compared against")
        if dp_axis is not None:
            raise ValueError(
                "dense_adam has no sketched all-reduce (moving dense (k, d)"
                " rows is the cost DP avoids) — run it without dp_axis")
    if mesh is not None:
        dp_axis = mesh_axis(mesh, dp_axis)
    axis = as_axis(dp_axis)
    hp = hparams if hparams is not None else SketchHParams(compression=100.0)
    if backend:
        hp = dataclasses.replace(hp, backend=backend)
    track = optimizer == "cs_adam"
    b1 = 0.9 if (track or dense) else 0.0
    stores = None
    if plan is not None:
        if bool(plan.track_first_moment) != track:
            raise ValueError(
                f"plan moment layout (track_first_moment="
                f"{plan.track_first_moment}) does not match optimizer "
                f"{optimizer!r} — solve the plan with optimizer={optimizer!r}")
        stores = plan.store_tree()
        if backend:
            stores = stores.with_backend(backend)
    opts: Dict[str, Transform] = {}
    first_only = dense
    for path, shape in cfg.table_shapes().items():
        if dense:
            opts[path] = dense_rows_adam(lr, b1=b1, shape=shape,
                                         device=device)
            continue
        m_store = v_store = None
        if stores is not None:
            m_store, v_store, track = resolve_sparse_stores(stores, path,
                                                            shape)
        if axis is not None:
            opts[path] = opt_lib.sparse_rows_adam_dp(
                lr, b1=b1, shape=shape, path=path, axis_name=axis,
                hparams=hp, track_first_moment=track,
                error_feedback=error_feedback, dir_clip=dir_clip,
                m_store=m_store, v_store=v_store, device=device)
            continue
        opts[path] = opt_lib.sparse_rows_adam(
            lr, b1=b1, shape=shape, path=path, hparams=hp,
            track_first_moment=track, m_store=m_store, v_store=v_store,
            device=device)
        # both tables resolve one backend: a plan pins it on every store
        first_only = opt_lib.first_occurrence_only(hp, v_store, device)

    def init_fn(generator: torch.Generator):
        scale = 1.0 / torch.sqrt(torch.tensor(cfg.dim, dtype=torch.float32))
        scale = scale.to(device)
        return {
            "tok_embed": {"table": torch.randn(
                (cfg.n_features, cfg.dim), generator=generator,
                dtype=torch.float32, device=device) * scale},
            "class_head": {"table": torch.randn(
                (cfg.n_meta, cfg.dim), generator=generator,
                dtype=torch.float32, device=device) * scale},
        }

    if axis is None:
        def apply(table, updates):
            return opt_lib.apply_sparse_updates(table, updates,
                                                first_only=first_only)
    else:
        apply = opt_lib.apply_unique_updates

    def step_fn(params, opt_state, batch):
        loss, grads = extreme_grads(params, batch)
        gn = torch.sqrt(sum(torch.sum(torch.square(g["rows"]))
                            for g in grads.values()))
        with scope("obs.dedup"):
            dr = true_div(sum(unique_id_ratio(g["ids"])
                              for g in grads.values()), float(len(grads)))
        if axis is not None:
            # the norm over every replica's rows, the ratio their mean
            with scope("obs.collective"):
                loss = axis.pmean(loss)
                gn = torch.sqrt(axis.psum(torch.square(gn)))
                dr = axis.pmean(dr)
        new_state = {}
        for path, opt in opts.items():
            top, leaf = path.split("/")
            updates, new_state[path] = opt.update(grads[path],
                                                  opt_state[path])
            apply(params[top][leaf], updates)
        return params, new_state, {"loss": loss, "grad_norm": gn,
                                   "dedup_ratio": dr}

    return init_fn, step_fn, opts
