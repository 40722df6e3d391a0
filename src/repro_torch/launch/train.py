"""Training driver: config -> step -> fault-tolerant loop, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \
        --steps 20 --batch 4 --seq 2048 --optimizer cs_adam \
        --store-backend auto --ckpt-dir build/run1

Counterpart of ``repro.launch.train`` for ``--workload lm``: that
workload's flags (the other workloads' flags come with their port),
the ``make_train_step`` step on the ``ZipfLM`` stream through
``Trainer``, checkpoints with the ``--aux-budget`` plan (recovered from
a manifest on resume), ``--store-backend`` ('auto': B3 on the sketched
tables), ``--metrics-dir`` telemetry, ``--profile-dir`` traces and the
``[train] ...`` line.  ``--reduced`` swaps in the smoke-size config.  It
runs on ``cuda`` unless ``--device cpu`` is given.  A recorded backend
is kept as it is: on a card ``tiled`` is B3.  The distributed flags
(``--dp``, ``--sketch-shards``, ``--error-feedback``) wait for ROADMAP
A13c; the
``sparse_embedding``, ``extreme`` and ``serve-replay`` workloads for
A14b.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.obs import MetricsWriter, PhaseTimer, RunObserver, maybe_trace
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState


def make_observer(args, run_meta):
    """A ``RunObserver`` over ``--metrics-dir``, or None when it is off."""
    if not args.metrics_dir:
        return None
    writer = MetricsWriter(args.metrics_dir, run_meta=run_meta)
    return RunObserver(writer, log_every=args.log_every,
                       phase_timer=PhaseTimer())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cpu only when asked)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="cs_adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", action="store_true",
                    help="data parallelism (ROADMAP A13c)")
    ap.add_argument("--workload", default="lm",
                    choices=["lm", "sparse_embedding", "extreme",
                             "serve-replay"],
                    help="lm: the full model train step; the others wait "
                         "for ROADMAP A14b")
    ap.add_argument("--sketch-cell-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="cell dtype of the planned sketches "
                         "(--aux-budget)")
    ap.add_argument("--sketch-shards", type=int, default=1,
                    help="sharded sketches (ROADMAP A13c)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="residual sketch of the sketched all-reduce "
                         "(ROADMAP A13c)")
    ap.add_argument("--aux-budget", default="",
                    help="optimizer aux-memory budget: bytes | '8.6GB' | "
                         "'0.85x' of dense | 'floor' | 'config'; the solved "
                         "plan replaces the regex sketch policy and is "
                         "recorded in every checkpoint manifest")
    ap.add_argument("--metrics-dir", default="",
                    help="write schema-versioned JSONL telemetry "
                         "(repro_torch.obs) into this directory")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--store-backend", default="",
                    help="kernel backend of the sketch hot paths ('ref' | "
                         "'xla' | 'tiled' | 'auto'; 'auto' and 'tiled' run "
                         "B3 on a card).  Empty = the composed form on the "
                         "dense path.  Overrides the backend a recorded "
                         "plan carries without touching the state layout")
    return ap


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
        print(plan.table(), flush=True)
    elif ckpt_plan is not None:
        plan = ckpt_plan
        print("[plan] recovered from checkpoint manifest "
              f"({plan.budget_bytes:,} B budget)", flush=True)
    if args.store_backend and plan is not None:
        plan = plan.with_backend(args.store_backend)
        print(f"[plan] store backend -> {args.store_backend}", flush=True)
    return plan


def run_lm(args) -> int:
    device = torch.device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = _plan(args, cfg)
    ts = make_train_step(cfg, optimizer=args.optimizer, lr=args.lr,
                         plan=plan, kernel_backend=args.store_backend or None,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = ts.init_fn(gen)
    opt_state = ts.optimizer.init(params)
    data = ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every)
    observer = make_observer(args, {
        "workload": "lm", "arch": cfg.name, "optimizer": args.optimizer,
        "steps": args.steps, "batch": args.batch, "dp": bool(args.dp),
        "aux_budget": args.aux_budget or None})
    trainer = Trainer(ts.step_fn, data, tcfg, plan=plan, observer=observer,
                      device=device)
    state = trainer.restore_or_init(
        TrainState(step=0, params=params, opt_state=opt_state))
    with maybe_trace(args.profile_dir or None):
        state = trainer.fit(state)

    hist = trainer.history
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    step_s = (np.mean([h["time_s"] for h in hist[5:]]) if len(hist) > 5
              else float("nan"))
    print(f"[train] arch={cfg.name} optimizer={args.optimizer} "
          f"dp={bool(args.dp)} steps={state.step} "
          f"loss {first:.3f} -> {last:.3f} ({step_s:.3f}s/step)", flush=True)
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.dp or args.sketch_shards > 1 or args.error_feedback:
        raise NotImplementedError(
            "--dp, --sketch-shards > 1 and --error-feedback are not "
            "ported to the launcher yet (ROADMAP A13c)")
    if args.workload != "lm":
        raise NotImplementedError(
            f"--workload {args.workload} is not ported to this launcher "
            f"yet (ROADMAP A14b); the port runs --workload lm")
    return run_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
