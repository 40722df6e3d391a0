"""Training driver: config -> step -> fault-tolerant loop, one process a card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \
        --steps 20 --batch 4 --seq 2048 --optimizer cs_adam \
        --store-backend auto --ckpt-dir build/run1

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train \
        --workload sparse_embedding --dp --error-feedback --steps 20

    PYTHONPATH=src python -m repro_torch.launch.train --workload extreme \
        --steps 20 --batch 1024 --classes 8000000 --meta-rows 2097152

    PYTHONPATH=src python -m repro_torch.launch.train \
        --workload serve-replay --sparse-rows 151936 --sparse-dim 896

Counterpart of ``repro.launch.train``, every workload:

  * ``lm``: the ``make_train_step`` step of a ``gqa``, ``moe``,
    ``encdec`` or ``vlm`` config on the ``ZipfLM`` stream (with zero
    stub ``frames`` or ``patches``) through ``Trainer``, the ``--aux-budget``
    plan recovered from a manifest on resume, ``--store-backend``
    'auto': B3 on the sketched tables;
  * ``sparse_embedding``: a zipf-touched table pulled toward a fixed
    target in the paper's (ids, grad-rows) regime (on a card B1 after
    the dedup sum, B5);
  * ``extreme``: ``--replicas`` MACH meta-classifiers with sampled
    softmax (``train.extreme.make_extreme_step``), one after the other,
    each with its own checkpoint directory ``replica{r}`` and metrics
    subdirectory; the optimizer defaults to ``cs_rmsprop`` (B1 without M
    on a card);
  * ``serve-replay``: a fixed-seed zipf trace replayed through
    ``serve.AdaptServer`` (the count-min arm, B1 once a batch on a
    card, or ``--optimizer dense_adam``), printing one ``[serve]`` line
    and, with ``--metrics-dir``, one ``serve`` record.

``--reduced`` swaps in the smoke-size config.  It runs on
``cuda`` unless ``--device cpu`` is given; a recorded backend is kept as
it is (on a card ``tiled`` is B3).

Processes.  Where the reference calls ``jax.distributed.initialize()``
under ``JAX_COORDINATOR``, this launcher starts a ``torch.distributed``
group when ``WORLD_SIZE`` is set (``torch.distributed.run`` sets it):
NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``, never one for
the other (a group already started by the caller is used as it is).
The processes form the grid (world / shards, shards) over ('data',
'model') (``process_group_mesh``), the counterpart of the reference's
host mesh:

  * ``--dp``: each process is one replica of the 'data' axis; every
    process draws the GLOBAL batch and keeps its block of dim 0
    (``sharding.batch_spec``), and the step's collectives run over the
    axis (the sparse step moves count sketches, the LM step ``pmean``s
    its gradients);
  * ``--sketch-shards N`` (sparse_embedding): the sketch state is cut
    into width slabs over 'model' (``sharding.sketch_state_specs``);
    ``--shard-layout`` picks 'width' (placement only: a checkpoint
    re-places onto another shard count) or 'hash' (the shard count is
    baked into the buckets, so a resume with another count is refused);
  * ``--error-feedback``: the residual sketch of the sketched all-reduce.

Checkpoints hold global leaves: each placed leaf is gathered over its
axes, process 0 writes, the others wait at a barrier; a restore loads
each process's block.  The table monitors of ``--metrics-dir`` read
global sketches the same way: under ``--sketch-shards`` every process
gathers the slabs at each log boundary and process 0 writes the
records.  Without ``--dp`` the rows of the grid repeat the
same step.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.distributed import sharding as shd
from repro_torch.obs import MetricsWriter, PhaseTimer, RunObserver, maybe_trace
from repro_torch.train.steps import (make_sparse_embedding_step,
                                     make_train_step, sparse_embedding_stores,
                                     stub_input)
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState


def say(*args, **kw) -> None:
    """``print`` on process 0 only (every process when there is no
    group)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0:
        print(*args, flush=True, **kw)


def make_observer(args, run_meta, monitors=(), subdir: str = "",
                  follow: bool = False):
    """A ``RunObserver`` over ``--metrics-dir`` (its ``subdir``) on
    process 0, or None when it is off.  ``follow``: the monitors read the
    state collectively (each replica holds slabs, gathered at every
    boundary), so every other replica gets a follower, an observer with no
    writer that enters the same gathers at the same boundaries."""
    if not args.metrics_dir:
        return None
    if args.rank != 0:
        return (RunObserver(None, monitors=monitors,
                            log_every=args.log_every) if follow else None)
    out = os.path.join(args.metrics_dir, subdir) if subdir \
        else args.metrics_dir
    writer = MetricsWriter(out, run_meta=run_meta)
    return RunObserver(writer, monitors=monitors, log_every=args.log_every,
                       phase_timer=PhaseTimer())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu only when asked); "
                         "under a process group, cuda:LOCAL_RANK")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="cs_adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", action="store_true",
                    help="data parallelism: each process of the group is "
                         "one replica of the 'data' axis, with its block "
                         "of the global batch")
    ap.add_argument("--workload", default="lm",
                    choices=["lm", "sparse_embedding", "extreme",
                             "serve-replay"],
                    help="lm: the full model train step; sparse_embedding: "
                         "the (ids, grad-rows) table regime (sketched "
                         "all-reduce under --dp); extreme: MACH + sampled "
                         "softmax over a --meta-rows output table "
                         "(paper §7.3, the big-batch regime); "
                         "serve-replay: replay a zipf traffic trace through "
                         "the online-adaptation server")
    ap.add_argument("--sparse-rows", type=int, default=65536)
    ap.add_argument("--sparse-dim", type=int, default=64)
    ap.add_argument("--sparse-compression", type=float, default=5.0)
    ap.add_argument("--sketch-cell-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="cell dtype of every sketch (bfloat16 halves the "
                         "bytes, int8 quarters them); recorded in the "
                         "checkpoint manifest, and a resume refuses a "
                         "change")
    ap.add_argument("--cleaning-every", type=int, default=0,
                    help="sparse_embedding: decay the count-min sketch "
                         "every N steps (paper §4 cleaning); 0 = off")
    ap.add_argument("--cleaning-alpha", type=float, default=0.2,
                    help="cleaning decay factor (paper §4)")
    ap.add_argument("--cleaning-mode", default="sync",
                    choices=("sync", "async"),
                    help="sync: the decay runs inside the step; async: an "
                         "AsyncCleaner dispatches it between steps (the "
                         "same bits)")
    ap.add_argument("--sketch-shards", type=int, default=1,
                    help="sparse_embedding: cut each (depth, width, dim) "
                         "sketch into this many width slabs over the "
                         "grid's 'model' axis; composes with --dp")
    ap.add_argument("--shard-layout", default="width",
                    choices=("width", "hash"),
                    help="width: contiguous width slabs, placement only "
                         "(re-placed across shard counts); hash: the "
                         "two-level owner hash keeps every id's rows on "
                         "one shard, and bakes the shard count into the "
                         "state")
    ap.add_argument("--serve-requests", type=int, default=256,
                    help="serve-replay: trace length (fixed --seed zipf)")
    ap.add_argument("--serve-ids-per-request", type=int, default=8)
    ap.add_argument("--serve-batch-ids", type=int, default=64,
                    help="serve-replay: id capacity of a coalesced batch")
    ap.add_argument("--serve-deadline-ms", type=float, default=2.0,
                    help="serve-replay: max time the batcher holds its "
                         "oldest request before dispatching a partial batch")
    ap.add_argument("--offered-load", type=float, default=500.0,
                    help="serve-replay: trace arrival rate, requests/s")
    ap.add_argument("--queue-cap", type=int, default=32,
                    help="serve-replay: admission-queue bound; arrivals "
                         "past it are shed, not delayed")
    ap.add_argument("--serve-slo-ms", type=float, default=250.0,
                    help="serve-replay: adapt-latency p99 SLO stamped into "
                         "the emitted serve record (obs.report warns on "
                         "violation)")
    ap.add_argument("--classes", type=int, default=1_000_000,
                    help="extreme: true-label space (MACH hashes it down "
                         "to --meta-rows per replica)")
    ap.add_argument("--meta-rows", type=int, default=131_072,
                    help="extreme: rows of each replica's meta output "
                         "table, the table the optimizer state covers")
    ap.add_argument("--replicas", type=int, default=2,
                    help="extreme: MACH meta-classifier count R")
    ap.add_argument("--features", type=int, default=65_536,
                    help="extreme: sparse feature vocabulary")
    ap.add_argument("--extreme-dim", type=int, default=64,
                    help="extreme: embedding width of both tables")
    ap.add_argument("--nnz", type=int, default=16,
                    help="extreme: active features per example")
    ap.add_argument("--negatives", type=int, default=1024,
                    help="extreme: shared sampled-softmax negatives")
    ap.add_argument("--error-feedback", action="store_true",
                    help="accumulate the 2nd moment's cross-replica term "
                         "in a residual sketch (MicroAdam-style)")
    ap.add_argument("--aux-budget", default="",
                    help="optimizer aux-memory budget: bytes | '8.6GB' | "
                         "'0.85x' of dense | 'floor' | 'config'; the solved "
                         "plan replaces the regex sketch policy and is "
                         "recorded in every checkpoint manifest")
    ap.add_argument("--metrics-dir", default="",
                    help="write schema-versioned JSONL telemetry "
                         "(repro_torch.obs) into this directory")
    ap.add_argument("--probe-rows", type=int, default=0,
                    help="sparse_embedding: shadow-probe K rows (half hot, "
                         "half cold) with exact dense moments and report "
                         "the measured sketch error (needs --metrics-dir)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--store-backend", default="",
                    help="kernel backend of the sketch hot paths ('ref' | "
                         "'xla' | 'tiled' | 'auto'; 'auto' and 'tiled' run "
                         "B1/B3 on a card).  Empty = the composed form on "
                         "the dense path, 'auto' on the sparse one.  "
                         "Overrides the backend a recorded plan carries "
                         "without touching the state layout")
    return ap


# ---------------------------------------------------------------------------
# Processes and the grid
# ---------------------------------------------------------------------------

def start_group(device: str):
    """``(device, started)``: the run's device, and whether this call
    started the process group (so the caller ends it).  A group is started
    from the environment when ``WORLD_SIZE`` is set: NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU; one the caller started must
    have the backend the device needs."""
    dist = torch.distributed
    dev = torch.device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_available() and dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(
                f"the process group's backend is {have!r}, but a "
                f"{dev.type} run needs {want!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, False
    if "WORLD_SIZE" not in os.environ:
        return dev, False
    if want == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run under WORLD_SIZE needs NCCL, "
                               "which this torch lacks")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(want, init_method="env://")
    return dev, True


def world() -> tuple:
    """(rank, world size) of the group, (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BlockStream:
    """A stream of global batches, each leaf cut to this replica's block
    (``sharding.batch_spec`` on ``grid`` at ``coords``): every process
    draws the same global batch, as the reference's one process over N
    devices splits one."""

    def __init__(self, stream, grid, coords):
        self.stream, self.grid, self.coords = stream, grid, coords

    def batch(self, step):
        return {k: shd.local_block(
                    v, shd.batch_spec(self.grid, np.shape(v)), self.grid,
                    self.coords).numpy()
                for k, v in self.stream.batch(step).items()}


def grid_shapes(args, size: int):
    """``(mesh shape, batch grid)`` of ``size`` processes: the process
    grid (size / shards, shards) and the grid the batch is cut on (data =
    1 without ``--dp``), after the reference's checks on the world size
    and the batch."""
    shards = args.sketch_shards
    if shards > 1:
        if size % shards != 0:
            raise ValueError(
                f"--sketch-shards {shards} needs the device count ({size}) "
                f"divisible by it — each shard owns one (depth, "
                f"local_width, dim) slab")
        dp = size // shards if args.dp else 1
        if args.dp and args.batch % dp != 0:
            raise ValueError(
                f"--dp needs the global batch ({args.batch}) divisible by "
                f"the data-axis size ({dp})")
    else:
        dp = size if args.dp else 1
        if args.dp and args.batch % size != 0:
            raise ValueError(
                f"--dp needs the global batch ({args.batch}) divisible by "
                f"the device count ({size})")
    return (size // shards, shards), shd.Grid((dp, shards))


def batch_coords(args, mesh) -> tuple:
    """This replica's coordinates on the batch grid (``grid_shapes``)."""
    if mesh is None:
        return (0, 0)
    d, s = mesh.coords
    return (d if args.dp else 0, s)


# ---------------------------------------------------------------------------
# lm
# ---------------------------------------------------------------------------

def _recorded_plan(ckpt_dir):
    """The plan a checkpoint's manifest recorded (checked against its
    StoreTree), or None."""
    if not ckpt_dir or store.latest_step(ckpt_dir) is None:
        return None
    saved = store.read_manifest(ckpt_dir).get("extra", {})
    if saved.get("plan") is None:
        return None
    from repro_torch.core.stores import StoreTree
    from repro_torch.plan import Plan
    plan = Plan.from_json(saved["plan"])
    if saved.get("store_tree") is not None and \
            StoreTree.from_json(saved["store_tree"]) != plan.store_tree():
        raise ValueError(
            f"{ckpt_dir}'s manifest is inconsistent: its serialized "
            f"StoreTree does not match the plan it was recorded with — "
            f"refusing to restore sketch state under ambiguous specs")
    return plan


def _plan(args, cfg):
    """The run's plan: solved from ``--aux-budget``, or recovered from the
    checkpoint's manifest; ``--store-backend`` applied last."""
    ckpt_plan = _recorded_plan(args.ckpt_dir)
    plan = None
    if args.aux_budget:
        from repro_torch.plan import plan_for_config
        plan = plan_for_config(cfg, args.aux_budget,
                               optimizer=args.optimizer,
                               sketch_dtype=args.sketch_cell_dtype)
        if ckpt_plan is None and args.ckpt_dir \
                and store.latest_step(args.ckpt_dir) is not None:
            raise ValueError(
                f"{args.ckpt_dir} holds a checkpoint written WITHOUT a "
                f"memory plan (regex-policy state); restoring it under "
                f"--aux-budget {args.aux_budget} would load mismatched "
                f"optimizer state — resume without the flag, or start a "
                f"fresh --ckpt-dir")
        if ckpt_plan is not None and \
                plan.with_backend(None) != ckpt_plan.with_backend(None):
            raise ValueError(
                f"--aux-budget {args.aux_budget} solves a plan that "
                f"differs from the one recorded in {args.ckpt_dir}'s "
                f"manifest ({ckpt_plan.budget_bytes:,} B budget) — resume "
                f"without --aux-budget to reuse the recorded plan, or "
                f"point --ckpt-dir at a fresh run")
        if ckpt_plan is not None and plan.backend is None:
            plan = plan.with_backend(ckpt_plan.backend)
        say(plan.table())
    elif ckpt_plan is not None:
        plan = ckpt_plan
        say("[plan] recovered from checkpoint manifest "
            f"({plan.budget_bytes:,} B budget)")
    if args.store_backend and plan is not None:
        plan = plan.with_backend(args.store_backend)
        say(f"[plan] store backend -> {args.store_backend}")
    return plan


def with_stub_inputs(step_fn, cfg):
    """``step_fn`` with the stub frontend's zero inputs added to every
    batch, as the reference's launcher adds them: ``frames`` (b,
    enc_seq, d_model) for the enc-dec, ``patches`` (b, n_patches,
    d_model) for the VLM, in ``cfg.dtype``, b the batch's own (a
    replica's block under ``--dp``); other families' step unchanged."""
    stub = stub_input(cfg)
    if stub is None:
        return step_fn
    key, length = stub

    def wrapped(params, opt_state, batch):
        tokens = batch["tokens"]
        zeros = torch.zeros((tokens.shape[0], length, cfg.d_model),
                            dtype=cfg.dtype, device=tokens.device)
        return step_fn(params, opt_state, dict(batch, **{key: zeros}))
    return wrapped


def run_lm(args, device, mesh, grid) -> int:
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = _plan(args, cfg)
    ts = make_train_step(cfg, optimizer=args.optimizer, lr=args.lr,
                         plan=plan, kernel_backend=args.store_backend or None,
                         dp_axis=mesh.axis("data") if args.dp else None,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = ts.init_fn(gen)
    opt_state = ts.optimizer.init(params)
    data = BlockStream(ZipfLM(ZipfLMConfig(
        vocab_size=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed)), grid, batch_coords(args, mesh))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every, host_id=args.rank)
    observer = make_observer(args, {
        "workload": "lm", "arch": cfg.name, "optimizer": args.optimizer,
        "steps": args.steps, "batch": args.batch, "dp": bool(args.dp),
        "aux_budget": args.aux_budget or None})
    # every leaf whole; under a group process 0 alone writes checkpoints
    trainer = Trainer(with_stub_inputs(ts.step_fn, cfg),
                      data, tcfg, plan=plan, observer=observer,
                      device=device, shardings=None if mesh is None
                      else shd.Placement(None, mesh))
    state = trainer.restore_or_init(
        TrainState(step=0, params=params, opt_state=opt_state))
    with maybe_trace(args.profile_dir or None):
        state = trainer.fit(state)

    hist = trainer.history
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    step_s = (np.mean([h["time_s"] for h in hist[5:]]) if len(hist) > 5
              else float("nan"))
    say(f"[train] arch={cfg.name} optimizer={args.optimizer} "
        f"dp={bool(args.dp)} steps={state.step} "
        f"loss {first:.3f} -> {last:.3f} ({step_s:.3f}s/step)")
    return 0


# ---------------------------------------------------------------------------
# sparse_embedding
# ---------------------------------------------------------------------------

def sparse_target(init_fn, seed: int, device) -> torch.Tensor:
    """The fixed table the sparse_embedding workload pulls toward: a second
    draw of ``init_fn`` (the reference's ``init_fn(PRNGKey(seed + 1))``;
    the two packages' generators differ)."""
    return init_fn(torch.Generator(device=device).manual_seed(seed + 1))


def check_recorded_layout(ckpt_dir, cell_dtype: str, layout: str,
                          shards: int) -> None:
    """The reference's resume checks of a sparse_embedding checkpoint
    against this run's sketch: the cell dtype and the shard layout must
    be the recorded ones, the hash layout its shard count; a width-layout
    state re-places onto another shard count (printed)."""
    if not ckpt_dir or store.latest_step(ckpt_dir) is None:
        return
    from repro_torch.core.stores import StoreTree
    saved = store.read_manifest(ckpt_dir).get("extra", {})
    rec = (StoreTree.from_json(saved["store_tree"])
           if saved.get("store_tree") is not None else None)
    rec_v = rec.rules[0][2] if rec is not None and rec.rules else None
    rec_shards = getattr(rec_v, "shards", 1)
    rec_layout = getattr(rec_v, "shard_layout", "width")
    rec_dtype = (rec_v.cell_dtype_name if rec_v is not None
                 and hasattr(rec_v, "cell_dtype_name") else "float32")
    if rec_dtype != cell_dtype:
        raise ValueError(
            f"{ckpt_dir} holds sketch state with {rec_dtype!r} "
            f"cells; restoring it under --sketch-cell-dtype "
            f"{cell_dtype} would silently reinterpret "
            f"quantized state — resume with --sketch-cell-dtype "
            f"{rec_dtype}, or start a fresh --ckpt-dir")
    if rec_layout != layout:
        raise ValueError(
            f"{ckpt_dir} holds sketch state in the "
            f"{rec_layout!r} shard layout; restoring it under "
            f"--shard-layout {layout} would read buckets hashed by a "
            f"different family — resume with the recorded layout")
    if layout == "hash" and rec_shards != shards:
        raise ValueError(
            f"{ckpt_dir} holds hash-layout sketch state built "
            f"for {rec_shards} shards; the two-level owner hash bakes "
            f"the shard count into every bucket, so restoring onto "
            f"{shards} shards would scramble the state — keep "
            f"--sketch-shards {rec_shards}, or use the width layout "
            f"(placement-only; elastic across shard counts)")
    if rec_shards != shards:
        say(f"[train] width-layout sketch state re-placed: "
            f"{rec_shards} -> {shards} shards (state bytes "
            f"identical; slabs re-routed at restore)")


def run_sparse_embedding(args, device, mesh, grid) -> int:
    """The (ids, grad-rows) workload: pull a zipf-touched table toward a
    fixed target (the gradient is ``table[ids] - target[ids]`` on the
    touched rows, a convergent quadratic), through the DP step under
    ``--dp`` and the sharded step under ``--sketch-shards``.  Exits 1
    unless the loss fell.  ``mesh``: the replicas' grid (a ``GroupMesh``,
    a ``ReplicaMesh`` from inside its threads, or None for one process);
    ``grid``: the batch's (``grid_shapes``)."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.core.stores import StoreTree

    n_rows, dim = args.sparse_rows, args.sparse_dim
    shards, layout = args.sketch_shards, args.shard_layout
    hp = SketchHParams(compression=args.sparse_compression,
                       backend=args.store_backend or None,
                       dtype=args.sketch_cell_dtype)
    cleaning = cleaner = None
    if args.cleaning_every > 0:
        from repro_torch.core.cleaning import AsyncCleaner, CleaningSchedule
        cleaning = CleaningSchedule(alpha=args.cleaning_alpha,
                                    every=args.cleaning_every,
                                    mode=args.cleaning_mode)
        if cleaning.mode == "async":
            cleaner = AsyncCleaner(cleaning)
    dp_axis = mesh.axis("data") if args.dp else None
    init_fn, step_fn, opt = make_sparse_embedding_step(
        n_rows, dim, lr=args.lr, hparams=hp, dp_axis=dp_axis,
        error_feedback=args.error_feedback, cleaning=cleaning,
        sketch_shards=shards, shard_layout=layout,
        shard_axis=mesh.axis("model") if shards > 1 else "model",
        device=device)
    # the executable vocabulary of the sketch state, recorded in every
    # manifest: a resume checks the cell dtype and the shard layout
    m_st, v_st = sparse_embedding_stores(n_rows, dim, hparams=hp,
                                         cleaning=cleaning,
                                         sketch_shards=shards,
                                         shard_layout=layout)
    run_tree = StoreTree(rules=(("sparse_embedding", m_st, v_st),))
    check_recorded_layout(args.ckpt_dir, args.sketch_cell_dtype, layout,
                          shards)
    data = BlockStream(ZipfLM(ZipfLMConfig(
        vocab_size=n_rows, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed)), grid, batch_coords(args, mesh))

    probe = None
    if args.metrics_dir and args.probe_rows > 0:
        from repro_torch.obs import TableProbe
        probe = TableProbe.for_table("sparse_embedding", n_rows,
                                     k=args.probe_rows)
    table = init_fn(torch.Generator(device=device).manual_seed(args.seed))
    opt_state = opt.init()
    if probe is not None:
        opt_state = dict(opt_state, probe=probe.init(dim, device))
    target = sparse_target(init_fn, args.seed, device)
    shardings = state_placement = None
    if mesh is not None:
        specs = {"params": (), "opt_state": (
            shd.sketch_state_specs(opt_state) if shards > 1 else None)}
        shardings = shd.Placement(specs, mesh)
        state_placement = shd.Placement(specs["opt_state"], mesh)
        opt_state = shd.place(opt_state, state_placement, device)

    monitors = []
    gathered = shards > 1 and state_placement is not None
    if args.metrics_dir:
        from repro_torch.obs import TableMonitor, predicted_table_errors
        monitors = [TableMonitor(
            path="sparse_embedding", m_store=m_st, v_store=v_st,
            probe=probe, cleaner=cleaner,
            predicted=predicted_table_errors(m_st, v_st, n_rows,
                                             alpha=data.stream.cfg.alpha),
            # each replica holds one slab of every sketch: the monitor
            # reads the global sketches, gathered by every replica at the
            # same boundary, as the reference's monitor reads its global
            # arrays (a copy: no sum, so no colliding adds)
            getter=(lambda st: shd.global_tree(st, state_placement))
            if gathered else None)]
    observer = make_observer(args, {
        "workload": "sparse_embedding", "rows": n_rows, "dim": dim,
        "compression": args.sparse_compression, "steps": args.steps,
        "batch": args.batch, "dp": bool(args.dp),
        "sketch_cell_dtype": args.sketch_cell_dtype,
        "probe_rows": args.probe_rows}, monitors, follow=gathered)
    axis = dp_axis

    def train_step(table, opt_state, batch):
        ids = batch["tokens"].reshape(-1).to(torch.int32)
        rows = table[ids] - target[ids]
        loss, sq = torch.mean(torch.square(rows)), torch.sum(
            torch.square(rows))
        if axis is not None:
            loss, sq = axis.pmean(loss), axis.psum(sq)
        inner = {k: v for k, v in opt_state.items() if k != "probe"}
        if probe is not None:
            # the shadow update sees the GLOBAL (ids, rows) batch
            g_ids, g_rows = ids, rows
            if axis is not None:
                g_ids = axis.all_gather(ids).reshape(-1)
                g_rows = axis.all_gather(rows).reshape(-1, dim)
            probe.update(opt_state["probe"], g_ids, g_rows)
        table, inner = step_fn(table, inner, ids, rows)
        if probe is not None:
            inner = dict(inner, probe=opt_state["probe"])
        return table, inner, {"loss": loss, "grad_norm": torch.sqrt(sq)}

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every, host_id=args.rank)
    trainer = Trainer(train_step, data, tcfg, observer=observer,
                      store_tree=run_tree, cleaner=cleaner, device=device,
                      shardings=shardings)
    state = trainer.restore_or_init(
        TrainState(step=0, params=table, opt_state=opt_state))
    with maybe_trace(args.profile_dir or None):
        state = trainer.fit(state)

    hist = trainer.history
    # a resumed run may hold fewer than 10 records: disjoint half-windows
    w = min(10, max(1, len(hist) // 2))
    first = np.mean([h["loss"] for h in hist[:w]])
    last = np.mean([h["loss"] for h in hist[-w:]])
    step_ms = (1e3 * np.mean([h["time_s"] for h in hist[1:]])
               if len(hist) > 1 else float("nan"))
    say(f"[train] {step_ms:.3f} ms a step after the first, "
        f"{len(hist)} steps in this process")
    say(f"[train] workload=sparse_embedding rows={n_rows} dim={dim} "
        f"dp={bool(args.dp)} shards={shards}({layout}) "
        f"feedback={bool(args.error_feedback)} "
        f"steps={state.step} loss {first:.4f} -> {last:.4f}")
    return 0 if last < first else 1


# ---------------------------------------------------------------------------
# serve-replay
# ---------------------------------------------------------------------------

def serve_table(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """The served table: (n_rows, dim) normals x 0.1 from ``seed`` (the
    reference's ``normal(PRNGKey(seed)) * 0.1``; the two packages'
    generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n_rows, dim), generator=gen, dtype=torch.float32,
                       device=device) * 0.1


def run_serve_replay(args, device) -> int:
    """The online-adaptation serving workload: replay a fixed-seed zipf
    traffic trace through the serving subsystem (bounded admission,
    size-or-deadline batching with cross-request dedup, double-buffered
    (table, sketch) state) and emit a schema-valid ``serve`` record.
    ``--optimizer dense_adam`` runs the dense-baseline arm; anything else
    runs the count-min arm sized by ``--sparse-compression`` (backend via
    ``--store-backend``; 'auto' is B1 on a card).  One process; under a
    group every process replays the same trace."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.serve import (AdaptServer, ServerConfig,
                                   make_dense_adapt_step,
                                   make_online_adapt_step, replay)
    from repro_torch.serve.traffic import (TraceConfig, make_trace,
                                           trace_stats)

    n_rows, dim = args.sparse_rows, args.sparse_dim
    trace = make_trace(TraceConfig(
        n_requests=args.serve_requests, n_rows=n_rows, dim=dim,
        ids_per_request=args.serve_ids_per_request,
        offered_load=args.offered_load, seed=args.seed))
    arm = "dense" if args.optimizer == "dense_adam" else "countmin"
    if arm == "dense":
        init_fn, adapt_fn = make_dense_adapt_step(n_rows, dim, lr=args.lr,
                                                  device=device)
    else:
        init_fn, adapt_fn = make_online_adapt_step(
            n_rows, dim, lr=args.lr,
            hparams=SketchHParams(compression=args.sparse_compression),
            store_backend=args.store_backend or None, device=device)
    server = AdaptServer(serve_table(n_rows, dim, args.seed, device),
                         init_fn(), adapt_fn, ServerConfig(
                             batch_ids=args.serve_batch_ids,
                             max_delay_s=args.serve_deadline_ms / 1e3,
                             queue_cap=args.queue_cap,
                             slo_p99_ms=args.serve_slo_ms))
    replay(server, trace)

    rec = server.metrics_record(offered_load=args.offered_load)
    if args.metrics_dir and args.rank == 0:
        with MetricsWriter(args.metrics_dir, run_meta={
                "workload": "serve-replay", "arm": arm, "rows": n_rows,
                "dim": dim, "compression": args.sparse_compression,
                "requests": args.serve_requests,
                "offered_load": args.offered_load}) as w:
            w.write("serve", **rec, **{f"trace_{k}": v
                                       for k, v in trace_stats(trace).items()})
    h = rec["adapt_ms"]
    say(f"[serve] arm={arm} rows={n_rows} dim={dim} "
        f"load={args.offered_load:.0f}/s requests={server.n_submitted} "
        f"batches={server.n_batches} shed={server.shed_rate:.3f} "
        f"adapt p50 {h['p50_ms']:.2f} ms p99 {h['p99_ms']:.2f} ms "
        f"adapts/s {rec['reads_per_s']:.1f}")
    return 0 if server.n_done > 0 else 1


# ---------------------------------------------------------------------------
# extreme
# ---------------------------------------------------------------------------

class ReplicaBatches:
    """A MACH replica's batches (``train.extreme.MetaStream`` on the host)
    with ``features`` and ``labels`` cut to this data-parallel replica's
    block of dim 0 and the shared ``negatives`` whole, as the reference's
    ``shard_map`` splits them."""

    def __init__(self, stream, rank: int, size: int):
        self.stream, self.rank, self.size = stream, rank, size

    def batch(self, step):
        b = self.stream.batch(step)
        n = b["labels"].shape[0] // self.size
        cut = slice(self.rank * n, (self.rank + 1) * n)
        return {"features": b["features"][cut], "labels": b["labels"][cut],
                "negatives": b["negatives"]}


def extreme_monitors(args, cfg, hp, plan):
    """Per-table health monitors over the step's own stores (store stats
    and the planner's predicted error: ``LeafPlan.predicted_error`` under
    a plan, the raw error model otherwise); none for ``dense_adam``,
    whose state is not sketched."""
    if not args.metrics_dir or args.optimizer == "dense_adam":
        return []
    from repro_torch.obs import TableMonitor, predicted_table_errors
    mons = []
    for path, shape in cfg.table_shapes().items():
        m_store, v_store = sparse_embedding_stores(
            shape[0], shape[1], hparams=hp,
            track_first_moment=(args.optimizer == "cs_adam"), path=path,
            stores=plan.store_tree() if plan else None)
        if plan is not None and plan.leaf(path) is not None:
            pred = {"v_pred_error": float(plan.leaf(path).predicted_error)}
        else:
            pred = predicted_table_errors(m_store, v_store, shape[0],
                                          alpha=cfg.alpha)
        mons.append(TableMonitor(path=path, m_store=m_store,
                                 v_store=v_store, predicted=pred,
                                 getter=lambda s, p=path: s[p]))
    return mons


def run_extreme(args, device, mesh, grid) -> int:
    """The MACH + sampled-softmax workload (paper §7.3 at table scale):
    ``--replicas`` independent meta-classifiers over an ``--meta-rows``
    output table, one after the other, gradients as (ids, rows) through
    the dedup pre-pass, sketch sizing solved by the planner from
    ``--aux-budget`` and, under ``--dp``, the sketched all-reduce over
    the process group's 'data' axis (each process its block of the
    batch).  Replica r's params are drawn from ``seed + r``.  Exits 1
    unless every replica's tail-window loss beats its head window."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.data import ExtremeStream
    from repro_torch.train.extreme import (MachConfig, MetaStream,
                                           make_extreme_step, plan_extreme)

    cfg = MachConfig(n_classes=args.classes, n_meta=args.meta_rows,
                     n_features=args.features, dim=args.extreme_dim,
                     n_replicas=args.replicas, nnz=args.nnz,
                     n_negatives=args.negatives, seed=args.seed)
    plan = None
    if args.aux_budget:
        plan = plan_extreme(cfg, args.aux_budget, optimizer=args.optimizer,
                            backend=args.store_backend or None,
                            sketch_dtype=args.sketch_cell_dtype)
        say(plan.table())
    hp = SketchHParams(compression=args.sparse_compression,
                       backend=args.store_backend or None,
                       dtype=args.sketch_cell_dtype)
    init_fn, step_fn, opts = make_extreme_step(
        cfg, optimizer=args.optimizer, lr=args.lr, hparams=hp, plan=plan,
        backend=args.store_backend or None,
        dp_axis="data" if args.dp else None,
        mesh=mesh if args.dp else None,
        error_feedback=args.error_feedback, device=device)
    rank, size = (batch_coords(args, mesh)[0], grid.shape[0])
    cmaps = cfg.class_maps()
    finals = []
    for r in range(cfg.n_replicas):
        data = ReplicaBatches(MetaStream(ExtremeStream(
            cfg.data_config(args.batch)), cmaps[r], device="cpu"),
            rank, size)
        params = init_fn(torch.Generator(device=device).manual_seed(
            args.seed + r))
        opt_state = {p: o.init() for p, o in opts.items()}
        ckpt = (os.path.join(args.ckpt_dir, f"replica{r}")
                if args.ckpt_dir else None)
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt,
                             ckpt_every=args.ckpt_every,
                             log_every=args.log_every, host_id=args.rank)
        observer = make_observer(args, {
            "workload": "extreme", "replica": r,
            "classes": cfg.n_classes, "meta_rows": cfg.n_meta,
            "optimizer": args.optimizer, "batch": args.batch,
            "dp": bool(args.dp)}, extreme_monitors(args, cfg, hp, plan),
            subdir=f"replica{r}")
        trainer = Trainer(step_fn, data, tcfg, plan=plan, observer=observer,
                          device=device, shardings=None if mesh is None
                          else shd.Placement(None, mesh))
        state = trainer.restore_or_init(
            TrainState(step=0, params=params, opt_state=opt_state))
        with maybe_trace(args.profile_dir if r == 0 else None):
            state = trainer.fit(state)
        hist = trainer.history
        # disjoint head/tail windows even on short smoke runs
        w = max(1, min(10, len(hist) // 3))
        first = np.mean([h["loss"] for h in hist[:w]])
        last = np.mean([h["loss"] for h in hist[-w:]])
        finals.append((first, last))
        step_ms = (1e3 * np.mean([h["time_s"] for h in hist[1:]])
                   if len(hist) > 1 else float("nan"))
        say(f"[train] {step_ms:.3f} ms a step after the first, replica {r}, "
            f"{len(hist)} steps in this process")
        say(f"[train] workload=extreme replica={r} "
            f"steps={state.step} loss {first:.4f} -> {last:.4f}")
    say(f"[train] workload=extreme classes={cfg.n_classes:,} "
        f"meta_rows={cfg.n_meta:,} replicas={cfg.n_replicas} "
        f"optimizer={args.optimizer} dp={bool(args.dp)} "
        f"batch={args.batch} per-replica losses "
        f"{[round(float(l), 4) for _, l in finals]}")
    return 0 if all(l < f for f, l in finals) else 1


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.probe_rows and not args.metrics_dir:
        ap.error("--probe-rows needs --metrics-dir (probe errors are "
                 "emitted as 'table' metrics records)")
    if args.sketch_cell_dtype == "int8" and (args.dp
                                             or args.sketch_shards > 1):
        ap.error("--sketch-cell-dtype int8 does not compose with --dp or "
                 "--sketch-shards: the per-(depth, block) absmax scales "
                 "need a whole-sketch view the sharded/collective paths "
                 "don't have — use bfloat16 there")
    if args.workload in ("extreme", "serve-replay") \
            and args.optimizer == ap.get_default("optimizer"):
        # both workloads default to the paper's Theorem 5.1 choice, not
        # the LM default; only when the user did not pick one
        args.optimizer = "cs_rmsprop"
    if args.sketch_shards > 1 and args.workload != "sparse_embedding":
        ap.error("--sketch-shards applies to the sparse_embedding "
                 "workload only (the sharded sparse-rows step)")
    device, started = start_group(args.device)
    try:
        args.rank, size = world()
        shape, grid = grid_shapes(args, size)
        mesh = None
        if torch.distributed.is_initialized():
            from repro_torch.distributed import process_group_mesh
            mesh = process_group_mesh(shape)
        elif args.dp or args.sketch_shards > 1:
            raise ValueError(
                "--dp and --sketch-shards need a process group: run under "
                "torch.distributed.run (which sets WORLD_SIZE)")
        if args.workload == "serve-replay":
            return run_serve_replay(args, device)
        if args.workload == "sparse_embedding":
            return run_sparse_embedding(args, device, mesh, grid)
        if args.workload == "extreme":
            return run_extreme(args, device, mesh, grid)
        return run_lm(args, device, mesh, grid)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
