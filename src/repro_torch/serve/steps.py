"""Serving steps of the port: model prefill/decode and serve-time sparse
adaptation.

Counterpart of ``repro.serve.steps``:

  * ``make_serve_step`` - prefill and decode of a model family (the
    ``gqa`` and ``moe`` transformers, ``rwkv6``, ``hybrid``, ``encdec``
    and ``vlm``), with ``cache_factory`` and ``ServeStep``; decode
    writes the cache (KV cache or recurrent state) in place;
  * ``make_online_adapt_step`` - the b1=0 CS-Adam of the training path
    (no first moment), its 2nd moment in a Count-Min sketch, through the
    same kernel backends (``tiled`` = B1 on the card); with ``dp_axis``
    a replicated fleet's replica, adapting one table from its own
    feedback shard through the sketched all-reduce;
  * ``make_dense_adapt_step`` - the dense baseline arm, the same rule
    with full (n, d) moments (``train.extreme.dense_rows_adam``);
  * ``timed_adapt`` - an adapt step under the ``obs.adapt`` span, its
    wall time (table AND optimizer state finished) in a
    ``LatencyTracker``.

Both adapt steps update the table and the optimizer state IN PLACE; a server
that must keep a published generation intact hands them a copy
(``serve.buffer.DoubleBufferedStore.begin_adapt``).
``ServeStep.cache_specs`` and ``param_shardings`` give the reference's
placement of the cache and the params as spec trees
(``distributed.sharding``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import optimizers as opt_lib
from repro_torch.core.optimizers import SketchHParams
from repro_torch.models.config import ArchConfig

def _family(cfg: ArchConfig):
    from repro_torch.train.steps import family_module
    return family_module(cfg)


def cache_factory(cfg: ArchConfig, device="cuda") -> Callable[..., Any]:
    """(batch, max_seq) -> zeroed cache for this family on ``device``
    (the transformer's KV cache, with a block axis under llama4's
    interleaved blocks, also the VLM's; rwkv6's recurrent state and
    ``len``; the hybrid's mamba state and shared-block KV caches; the
    enc-dec's self and cross caches)."""
    mod = _family(cfg)
    if cfg.family == "rwkv6":
        def make(batch, max_seq):
            state = mod.zero_state(cfg, batch, device=device)
            state["len"] = torch.zeros((), dtype=torch.int32)
            return state
        return make
    return lambda batch, max_seq: mod.init_cache(cfg, batch, max_seq,
                                                 device=device)


@dataclasses.dataclass
class ServeStep:
    cfg: ArchConfig
    prefill_fn: Callable      # (params, batch) -> (logits, cache)
    decode_fn: Callable       # (params, cache, token) -> (logits, cache)
    max_seq: int
    batch: int

    def cache_shape(self):
        """The cache as ``meta`` tensors (no allocation)."""
        return cache_factory(self.cfg, "meta")(batch=self.batch,
                                               max_seq=self.max_seq)

    def params_shape(self):
        return _family(self.cfg).init(None, self.cfg, device="meta")

    def cache_specs(self, mesh):
        """A spec for each cache leaf: the first batch-sized dim among the
        leading three over the DP axes, then ONE 'model' dim: a sequence
        dim (KV-cache sequence parallelism), else a head-count dim."""
        from repro_torch.distributed import sharding as shd
        cfg = self.cfg
        model = shd.axis_sizes(mesh).get("model", 1)
        dp = shd.dp_axes(mesh, self.batch)
        head_sizes = set()
        if cfg.family == "rwkv6":
            head_sizes.add(cfg.rwkv_heads)
        if cfg.family == "hybrid":
            head_sizes.add(cfg.ssm_heads)

        def leaf(_path, x):
            shape = tuple(x.shape)
            axes: list = [None] * len(shape)
            batch_i = next((i for i, dim in enumerate(shape[:3])
                            if dim == self.batch and dp), None)
            if batch_i is not None:
                axes[batch_i] = dp if len(dp) > 1 else dp[0]
            cand = [i for i, dim in enumerate(shape)
                    if i != batch_i and dim in (self.max_seq, cfg.enc_seq)
                    and dim % model == 0 and dim > 8]
            if not cand:
                cand = [i for i, dim in enumerate(shape)
                        if i != batch_i and dim in head_sizes
                        and dim % model == 0]
            if cand:
                axes[cand[0]] = "model"
            return shd.spec_of(axes)

        return shd.map_leaves(leaf, self.cache_shape())

    def param_shardings(self, mesh):
        """The params' spec tree (``sharding.param_specs``)."""
        from repro_torch.distributed import sharding as shd
        return shd.param_specs(self.params_shape(), mesh,
                               fsdp=self.cfg.fsdp,
                               expert_sharding=self.cfg.expert_sharding)


def make_serve_step(cfg: ArchConfig, *, batch: int, max_seq: int
                    ) -> ServeStep:
    """Prefill ``{"tokens": (batch, s)}`` (with ``"frames"`` (batch,
    enc_seq, d) for the enc-dec, ``"patches"`` (batch, n_patches, d) for
    the VLM) into a ``max_seq`` cache and decode one token a call, both
    without autograd.  The cache lives on the tokens' device;
    ``decode_fn`` writes it in place.  rwkv6's cache is its recurrent
    state and ``len``: prefill sets ``len`` to the prompt's length, and
    decode steps the state without it, then adds one."""
    from repro_torch.train.steps import stub_input
    mod = _family(cfg)
    stub = stub_input(cfg)

    @torch.no_grad()
    def prefill_fn(params, batch_in):
        front = (batch_in[stub[0]],) if stub else ()
        logits, cache = mod.prefill(cfg, params, *front, batch_in["tokens"],
                                    max_seq)
        if cfg.family == "rwkv6":
            cache["len"] = torch.tensor(batch_in["tokens"].shape[1],
                                        dtype=torch.int32)
        return logits, cache

    @torch.no_grad()
    def decode_fn(params, cache, token):
        if cfg.family != "rwkv6":
            return mod.decode_step(cfg, params, cache, token)
        state = {k: v for k, v in cache.items() if k != "len"}
        logits, state = mod.decode_step(cfg, params, state, token)
        state["len"] = torch.tensor(int(cache["len"]) + 1, dtype=torch.int32)
        return logits, state

    return ServeStep(cfg=cfg, prefill_fn=prefill_fn, decode_fn=decode_fn,
                     max_seq=max_seq, batch=batch)


# the caller did not choose a dir_clip: distinguishable from an explicit
# 10.0 (or None), so the single-device step can reject dp-only arguments
_DIR_CLIP_DEFAULT = object()


def make_online_adapt_step(n_rows: int, dim: int, *, lr=1e-4,
                           b2: float = 0.999, eps: float = 1e-8,
                           hparams: Optional[SketchHParams] = None,
                           path: str = "serve_adapt",
                           v_store=None,
                           store_backend: Optional[str] = None,
                           dp_axis=None,
                           error_feedback: bool = False,
                           dir_clip=_DIR_CLIP_DEFAULT,
                           device="cuda"):
    """Returns ``(init_state_fn, adapt_fn)``:

        opt_state          = init_state_fn()
        table', opt_state' = adapt_fn(table, opt_state, ids, grad_rows)

    ``adapt_fn`` updates the table and the sketch IN PLACE.
    ``store_backend`` pins the kernel backend, overriding both
    ``hparams.backend`` and the backend ``v_store`` carries.

    ``dp_axis``: a replicated fleet adapting ONE table from per-replica
    feedback shards.  Each replica of that axis (``repro_torch.
    distributed.collectives``) calls ``adapt_fn`` with its own shard and
    its own copy of the table and state; the collective all-reduces the
    (depth, width, dim) 2nd-moment gradient sketch and the int32 ids, so
    every replica keeps the same table and sketch bits.
    ``error_feedback`` and ``dir_clip`` (default 10 on this path) exist
    only there and are rejected without ``dp_axis``, as in the
    reference."""
    hp = hparams if hparams is not None else SketchHParams()
    if store_backend is not None:
        hp = dataclasses.replace(hp, backend=store_backend)
        if v_store is not None:
            v_store = dataclasses.replace(v_store, backend=store_backend)
    if dp_axis is None:
        if error_feedback:
            raise ValueError(
                "error_feedback=True needs dp_axis: the residual sketch "
                "accumulates the cross-replica 2nd-moment term of the "
                "sketched all-reduce; a single-device adapt step has no "
                "such term")
        if dir_clip is not _DIR_CLIP_DEFAULT:
            raise ValueError(
                "dir_clip only applies to the dp_axis path (it trust-"
                "clamps the direction against sketched-reduce estimator "
                "noise); the single-device step would silently ignore it")
        opt = opt_lib.sparse_rows_adam(
            lr, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
            hparams=hp, track_first_moment=False, v_store=v_store,
            device=device)
        first_only = opt_lib.first_occurrence_only(hp, v_store, device)

        def apply(table, updates):
            return opt_lib.apply_sparse_updates(table, updates,
                                                first_only=first_only)
    else:
        opt = opt_lib.sparse_rows_adam_dp(
            lr, b2=b2, eps=eps, shape=(n_rows, dim), path=path,
            axis_name=dp_axis, hparams=hp, track_first_moment=False,
            error_feedback=error_feedback,
            dir_clip=10.0 if dir_clip is _DIR_CLIP_DEFAULT else dir_clip,
            v_store=v_store, device=device)
        apply = opt_lib.apply_unique_updates

    def init_state_fn():
        return opt.init()

    def adapt_fn(table, opt_state, ids, grad_rows):
        updates, opt_state = opt.update(
            {"ids": ids, "rows": grad_rows}, opt_state)
        return apply(table, updates), opt_state

    return init_state_fn, adapt_fn


def make_dense_adapt_step(n_rows: int, dim: int, *, lr=1e-4,
                          b2: float = 0.999, eps: float = 1e-8,
                          device="cuda"):
    """Dense-baseline sibling of ``make_online_adapt_step``: the b1=0
    rule with full (n, d) moments (``dense_rows_adam``, ``{"step", "m",
    "v"}``) instead of a Count-Min sketch, the memory the sketch arm
    frees.  Same ``(init_state_fn, adapt_fn)`` contract; per-step work
    stays O(touched rows), and the updates carry each id's update at its
    first occurrence only, so one ``index_add_`` applies them."""
    from repro_torch.train.extreme import dense_rows_adam
    opt = dense_rows_adam(lr, b1=0.0, b2=b2, eps=eps, shape=(n_rows, dim),
                          device=device)

    def init_state_fn():
        return opt.init()

    def adapt_fn(table, opt_state, ids, grad_rows):
        updates, opt_state = opt.update(
            {"ids": ids, "rows": grad_rows}, opt_state)
        return opt_lib.apply_sparse_updates(table, updates,
                                            first_only=True), opt_state

    return init_state_fn, adapt_fn


def timed_adapt(adapt_fn, tracker=None, *, capacity: int = 4096):
    """Wrap an ``adapt_fn`` with serve-latency telemetry.

    Returns ``(wrapped_adapt_fn, tracker)``: each call runs under the
    ``obs.adapt`` span, waits until the card has finished BOTH the table
    and the optimizer state (a ``torch.cuda.synchronize()``: the sketch
    write is the bulk of the step, and a wait on the table alone would
    leave it out), and records the wall time into an
    ``obs.LatencyTracker``.  ``tracker`` lets several tables share one
    histogram."""
    from repro_torch.obs.profiling import LatencyTracker, _trace_annotation
    lat = tracker if tracker is not None else LatencyTracker(capacity)

    def wrapped(table, opt_state, ids, grad_rows):
        t0 = time.perf_counter()
        with _trace_annotation("obs.adapt"):
            table, opt_state = adapt_fn(table, opt_state, ids, grad_rows)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        lat.record(time.perf_counter() - t0)
        return table, opt_state

    return wrapped, lat
