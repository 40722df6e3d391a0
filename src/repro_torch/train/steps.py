"""Train-step factories: the LM step (family dispatch + optimizer) and the
step for one embedding/softmax table fed (ids, grad-rows).

Counterpart of ``repro.train.steps``.  ``dp_axis`` runs a step body as
one replica of a data-parallel axis (``repro_torch.distributed.
collectives``): each replica calls ``step_fn`` with its own shard of the
batch and its own copy of the replicated params and state, where the
reference wraps the body in ``shard_map``.  ``sketch_shards > 1`` runs
the sparse step on one shard's slabs of the sketch state, each replica
of a (dp × shard) grid holding its own (``distributed.slabs``).
``TrainStep.shardings(mesh, batch)`` gives the reference's placement of
the params, optimizer state, batch and metrics as spec trees
(``distributed.sharding``).

``make_train_step(cfg, ...)`` returns a ``TrainStep``:

    params = ts.init_fn(generator)           # or ts.params_shape() (meta)
    params, opt_state, metrics = ts.step_fn(params, opt_state, batch)

Optimizer modes (paper §4 + baselines):
    dense_adam      — full-size Adam (the paper's baseline)
    cs_adam         — Count-Sketch Adam, 1st+2nd moment sketched (CS-MV)
    cs_adam_v       — only the 2nd moment sketched (CS-V)
    cs_rmsprop      — β₁=0 Count-Min variant of Theorem 5.1
    cs_adagrad      — Count-Min Adagrad (paper Alg. 3)
    cs_momentum     — Count-Sketch momentum (paper Alg. 2)
    lr_nmf_adam     — NMF rank-1 2nd-moment baseline (paper's LR-NMF-V)
    dense_adagrad / dense_momentum — their dense baselines
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import lowrank
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.cleaning import CleaningSchedule
from repro_torch.core.optimizers import SketchHParams
from repro_torch.core.partition import SketchPolicy, leaf_paths
from repro_torch.core.transforms import (Transform, clip_by_global_norm,
                                         tree_map_with_path)
from repro_torch.distributed.collectives import as_axis
from repro_torch.models.config import ArchConfig
from repro_torch.obs.profiling import scope


def family_module(cfg: ArchConfig):
    """The model module of ``cfg.family``: the transformer for the dense
    ``gqa`` and the ``moe`` families, ``rwkv`` for ``rwkv6``, ``mamba``
    for ``hybrid``, ``granite`` for ``hybrid_moe``, ``encdec`` and
    ``vlm``."""
    from repro_torch.models import (encdec, granite, mamba, rwkv,
                                    transformer, vlm)
    return {"gqa": transformer, "moe": transformer, "rwkv6": rwkv,
            "hybrid": mamba, "hybrid_moe": granite, "encdec": encdec,
            "vlm": vlm}[cfg.family]


def stub_input(cfg: ArchConfig) -> Optional[Tuple[str, int]]:
    """``(batch key, length)`` of the stub frontend's embeddings that the
    family's model takes before its tokens: the enc-dec's ``frames``
    (enc_seq), the VLM's ``patches`` (n_patches); None for the others."""
    return {"encdec": ("frames", cfg.enc_seq),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)


def build_optimizer(cfg: ArchConfig, mode: str, lr=1e-3,
                    cleaning: Optional[CleaningSchedule] = None,
                    kernel_backend: Optional[str] = None,
                    plan=None) -> Transform:
    """``kernel_backend`` routes BOTH sketch hot paths: the sparse-rows
    step and the dense whole-gradient fused ``update_read`` of every
    sketched store ('auto': B3 on a card).  None keeps the dense path on
    the composed chunked form, which reaches no kernel, as in the
    reference.

    ``plan``: a solved ``repro_torch.plan.Plan``; it supersedes the regex
    policy and the global compression (its ``StoreTree`` executes through
    ``adam_from_stores``), with ``kernel_backend`` overriding the backend
    the plan carries.  Only the modes in ``plan.MOMENT_MODES`` take one."""
    if plan is not None:
        from repro_torch.plan import MOMENT_MODES
        if mode not in MOMENT_MODES:
            raise ValueError(
                f"optimizer mode {mode!r} cannot execute a memory plan "
                f"(Adam-family layouts only: {sorted(MOMENT_MODES)})")
        return plan.make_optimizer(lr, cleaning=cleaning,
                                   backend=kernel_backend)
    policy = SketchPolicy(min_rows=1024)
    hp = SketchHParams(compression=cfg.sketch_compression,
                       depth=cfg.sketch_depth, backend=kernel_backend)
    if mode == "dense_adam":
        return opt_lib.adam(lr)
    if mode == "dense_adagrad":
        return opt_lib.adagrad(lr)
    if mode == "dense_momentum":
        return opt_lib.momentum(lr)
    if mode == "cs_adam":
        return opt_lib.countsketch_adam(lr, policy=policy, hparams=hp,
                                        cleaning=cleaning)
    if mode == "cs_adam_v":
        # CS-V: dense 1st moment, sketched 2nd
        return opt_lib.countsketch_adam(
            lr, policy=policy, hparams=hp, cleaning=cleaning,
            track_first_moment=True, sketch_first_moment=False)
    if mode == "cs_rmsprop":
        return opt_lib.countsketch_rmsprop(lr, policy=policy, hparams=hp,
                                           cleaning=cleaning)
    if mode == "cs_adagrad":
        return opt_lib.countsketch_adagrad(lr, policy=policy, hparams=hp,
                                           cleaning=cleaning)
    if mode == "cs_momentum":
        return opt_lib.countsketch_momentum(lr, policy=policy, hparams=hp)
    if mode == "lr_nmf_adam":
        return lowrank.nmf_rank1_adam(lr, policy=policy)
    raise ValueError(f"unknown optimizer mode {mode!r}")


@dataclasses.dataclass
class TrainStep:
    cfg: ArchConfig
    init_fn: Callable
    step_fn: Callable
    optimizer: Transform
    batch_template: Dict[str, Any]
    # the run's StoreTree when a memory plan executes
    store_tree: Any = None
    dp_axis: Any = None

    # -- shape trees (``meta`` tensors: no allocation) --------------------
    def params_shape(self):
        return family_module(self.cfg).init(None, self.cfg, device="meta")

    def opt_shape(self, params_shape=None):
        ps = params_shape if params_shape is not None else self.params_shape()
        return self.optimizer.init(ps)

    def shardings(self, mesh, batch_specs: Dict[str, Any]):
        """``(params, opt_state, batch, metrics)`` spec trees on ``mesh``:
        the params by the rule table, the state ZeRO-1 and sketch layout
        (exact under a plan's ``store_tree``), each batch leaf (anything
        with a ``shape``) over the DP axes, the metrics replicated.
        Built on ``meta`` tensors, so nothing is allocated."""
        from repro_torch.distributed import sharding as shd
        cfg = self.cfg
        ps = self.params_shape()
        pspec = shd.param_specs(ps, mesh, fsdp=cfg.fsdp,
                                expert_sharding=cfg.expert_sharding)
        ospec = shd.opt_specs_for_state(self.opt_shape(ps), ps, mesh,
                                        fsdp=cfg.fsdp,
                                        expert_sharding=cfg.expert_sharding,
                                        store_tree=self.store_tree)
        bspec = {k: shd.batch_spec(mesh, tuple(v.shape))
                 for k, v in batch_specs.items()}
        return pspec, ospec, bspec, ()


def _grad_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for _path, g in leaf_paths(grads)))


def make_train_step(cfg: ArchConfig, *, optimizer: str = "cs_adam",
                    lr=1e-3, remat: bool = True,
                    sampled_softmax: bool = False,
                    grad_clip: Optional[float] = 1.0,
                    cleaning: Optional[CleaningSchedule] = None,
                    kernel_backend: Optional[str] = None,
                    plan=None, dp_axis=None,
                    device="cuda") -> TrainStep:
    """The LM train step in the reference's order: loss and gradient
    (``obs.grad``: the loss in ``obs.forward``, the gradient in
    ``obs.backward``), ``clip_by_global_norm(grad_clip)`` with the norm
    of the clipped gradient (``obs.clip``), ``opt.update``
    (``obs.kernel``), ``apply_updates`` (``obs.apply``); the metrics are
    ``loss`` and ``grad_norm`` (device scalars).  ``step_fn`` updates
    params and optimizer state IN PLACE.  ``init_fn(generator)`` draws
    the model's params on ``device`` from a ``torch.Generator`` (not
    ``jax.random``: start both packages from one state with
    ``repro_torch.convert``).

    ``dp_axis``: each replica of that axis calls ``step_fn`` with its
    shard of the batch; the loss and every gradient leaf are ``pmean``'d
    (``obs.collective``) before the clip, so the metrics and the update
    are the global batch's."""
    axis = as_axis(dp_axis)
    mod = family_module(cfg)
    opt = build_optimizer(cfg, optimizer, lr=lr, cleaning=cleaning,
                          kernel_backend=kernel_backend, plan=plan)
    clip = (clip_by_global_norm(grad_clip)
            if grad_clip is not None else (lambda g: g))

    def step_fn(params, opt_state, batch):
        # differentiate through aliases of the params, so the caller's
        # tensors keep requires_grad off and take the update in place
        live = tree_map_with_path(
            lambda _p, x: x.detach().requires_grad_(True), params)
        leaves = leaf_paths(live)
        with scope("obs.grad"):
            with scope("obs.forward"):
                loss = mod.train_loss(cfg, live, batch, remat=remat,
                                      sampled_softmax=sampled_softmax)
            # remat's recompute of the forward runs in here
            with scope("obs.backward"):
                grad_list = torch.autograd.grad(
                    loss, [x for _p, x in leaves])
        by_path = {p: g for (p, _x), g in zip(leaves, grad_list)}
        grads = tree_map_with_path(lambda p, _x: by_path[p], params)
        # the clip makes a scaled copy: with no other reference left, the
        # unclipped gradients are freed before the optimizer runs
        del grad_list, by_path
        loss = loss.detach()
        if axis is not None:
            with scope("obs.collective"):
                loss = axis.pmean(loss)
                grads = tree_map_with_path(lambda _p, g: axis.pmean(g),
                                           grads)
        with scope("obs.clip"):
            grads = clip(grads)
            grad_norm = _grad_norm(grads)
        with scope("obs.kernel"):
            updates, opt_state = opt.update(grads, opt_state, params)
        with scope("obs.apply"):
            params = opt_lib.apply_updates(params, updates)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": grad_norm}
        return params, opt_state, metrics

    def init_fn(generator: Optional[torch.Generator] = None):
        return mod.init(generator, cfg, device=device)

    return TrainStep(cfg=cfg, init_fn=init_fn, step_fn=step_fn,
                     optimizer=opt, batch_template={},
                     store_tree=plan.store_tree() if plan is not None
                     else None, dp_axis=dp_axis)


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
                            path: str = "sparse_embedding", stores=None,
                            sketch_shards: int = 1,
                            shard_layout: str = "width"):
    """The (m_store, v_store) pair ``make_sparse_embedding_step`` binds
    for the same table arguments, re-stamped with the sharding as
    ``sparse_rows_adam_sharded`` re-stamps it."""
    hp = hparams if hparams is not None else SketchHParams()
    m_store = v_store = None
    if stores is not None:
        m_store, v_store, track_first_moment = resolve_sparse_stores(
            stores, path, (n_rows, dim))
    m_store, v_store = opt_lib.sparse_rows_stores(
        (int(n_rows), int(dim)), path, hp,
        track_first_moment=track_first_moment, cleaning=cleaning,
        m_store=m_store, v_store=v_store)
    if sketch_shards > 1:
        if m_store is not None:
            m_store = m_store.with_sharding(sketch_shards, shard_layout)
        v_store = v_store.with_sharding(sketch_shards, shard_layout)
    return m_store, v_store


def make_sparse_embedding_step(n_rows: int, dim: int, *, lr=1e-3,
                               b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8,
                               hparams: Optional[SketchHParams] = None,
                               track_first_moment: bool = True,
                               cleaning: Optional[CleaningSchedule] = None,
                               path: str = "sparse_embedding",
                               stores=None,
                               dp_axis=None,
                               error_feedback: bool = False,
                               dir_clip: Optional[float] = 10.0,
                               sketch_shards: int = 1,
                               shard_layout: str = "width",
                               shard_axis="model",
                               device="cuda"):
    """Train step for the (ids, grad-rows) regime, where per-step work is
    O(touched rows).  Returns ``(init_fn, step_fn, optimizer)``:

        table     = init_fn(generator)             # (n_rows, dim) f32
        opt_state = optimizer.init()
        table', opt_state' = step_fn(table, opt_state, ids, grad_rows)

    ``step_fn`` updates the table and the sketches IN PLACE.  The
    optimizer is ``sparse_rows_adam``, routed through the backend named by
    ``hparams.backend`` ('auto': the CUDA kernel pipeline ``tiled`` on a
    card, plain ``xla`` on the CPU).  Its stages are profiler spans: the
    backend's ``obs.dedup``, ``obs.hash`` and ``obs.adam_rows``
    (``kernels/ops.py``), then the apply, ``obs.apply``; the learning
    rate's scale of the direction (``scale_by_lr``) lies between them.
    ``init_fn`` draws from a ``torch.Generator``, so its numbers differ
    from the reference's ``jax.random.normal``; start both packages from
    one state with ``repro_torch.convert.from_jax_state``.

    ``dp_axis``: data parallelism.  Each replica of that axis (a
    ``ReplicaGroup`` thread or a ``ProcessGroupAxis`` process) calls
    ``step_fn(table, opt_state, local_ids, local_rows)`` with its own
    shard of the global batch and its own copy of the replicated table
    and state; the collectives move the (depth, width, dim) gradient
    sketches and the int32 ids (``sparse_rows_adam_dp``).  The 1st moment
    evolves as the single-device step's on the concatenated batch; the
    2nd misses the cross-replica square terms unless ``error_feedback``
    adds the residual sketch, and ``dir_clip`` trust-clamps the direction
    (None disables).  Both apply only with ``dp_axis`` or sharding.

    ``sketch_shards > 1``: the sketch state is cut into width slabs over
    ``shard_axis`` (layout 'width' or 'hash'; ``sparse_rows_adam_
    sharded``).  ``opt.init()`` is the full state; each replica of the
    (dp × shard) grid calls ``step_fn`` with its shard's slabs of it
    (``distributed.slabs.shard_state(state, sketch_shards,
    shard_axis.rank)``), its dp shard of the batch (the whole batch
    without ``dp_axis``) and its own copy of the table, which every
    replica updates alike.  The shard axis must have exactly
    ``sketch_shards`` replicas, checked at call time with the slab's
    shape."""
    hp = hparams if hparams is not None else SketchHParams()
    m_store = v_store = None
    if stores is not None:
        # the tree's moment layout is authoritative
        m_store, v_store, track_first_moment = resolve_sparse_stores(
            stores, path, (n_rows, dim))
    if sketch_shards > 1:
        m_store, v_store = sparse_embedding_stores(
            n_rows, dim, hparams=hp, track_first_moment=track_first_moment,
            cleaning=cleaning, path=path, stores=stores,
            sketch_shards=sketch_shards, shard_layout=shard_layout)
        opt = opt_lib.sparse_rows_adam_sharded(
            lr, b1=b1, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
            shards=sketch_shards, shard_layout=shard_layout,
            shard_axis=shard_axis, dp_axis=dp_axis, hparams=hp,
            track_first_moment=track_first_moment, cleaning=cleaning,
            error_feedback=error_feedback, dir_clip=dir_clip,
            m_store=m_store, v_store=v_store, device=device)
    elif dp_axis is None:
        opt = opt_lib.sparse_rows_adam(
            lr, b1=b1, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
            hparams=hp, track_first_moment=track_first_moment,
            cleaning=cleaning, m_store=m_store, v_store=v_store,
            device=device)
    else:
        opt = opt_lib.sparse_rows_adam_dp(
            lr, b1=b1, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
            axis_name=dp_axis, hparams=hp,
            track_first_moment=track_first_moment, cleaning=cleaning,
            error_feedback=error_feedback, dir_clip=dir_clip,
            m_store=m_store, v_store=v_store, device=device)

    def init_fn(generator: torch.Generator) -> torch.Tensor:
        scale = 1.0 / torch.sqrt(torch.tensor(dim, dtype=torch.float32))
        table = torch.randn((n_rows, dim), generator=generator,
                            dtype=torch.float32, device=device)
        return table * scale.to(device)

    if dp_axis is None and sketch_shards == 1:
        first_only = opt_lib.first_occurrence_only(hp, v_store, device)

        def apply(table, updates):
            return opt_lib.apply_sparse_updates(table, updates,
                                                first_only=first_only)
    else:
        apply = opt_lib.apply_unique_updates

    def step_fn(table, opt_state, ids, grad_rows):
        if sketch_shards > 1:
            _check_slab(v_store.spec.slab_shape, sketch_shards, shard_axis,
                        opt_state)
        updates, opt_state = opt.update(
            {"ids": ids, "rows": grad_rows}, opt_state)
        with scope("obs.apply"):
            table = apply(table, updates)
        return table, opt_state

    return init_fn, step_fn, opt


def _check_slab(want, sketch_shards: int, shard_axis, opt_state) -> None:
    """The shard axis has ``sketch_shards`` replicas and the state handed
    in holds one shard's (depth, local_width, dim) slab."""
    from repro_torch.distributed.collectives import as_axis
    size = as_axis(shard_axis).size
    if size != sketch_shards:
        raise ValueError(
            f"sketch_shards={sketch_shards} needs the shard axis to be "
            f"exactly that size, got {size}: each replica must hold one "
            f"shard's (depth, local_width, dim) slab")
    got = tuple(opt_state["v"].shape)
    if got != want:
        raise ValueError(
            f"the v state handed to a sharded step is {got}, not one "
            f"shard's slab {want}: cut opt.init() with "
            f"distributed.slabs.shard_state")
