"""Plan CLI: solve and print a memory-budget plan for a registry config.

    PYTHONPATH=src python -m repro_torch.plan.cli --arch qwen2_0_5b --budget 0.85x
    PYTHONPATH=src python -m repro_torch.plan.cli --arch qwen2_0_5b \
        --budgets floor,0.9x,1.0x --check

Counterpart of ``repro.plan.cli``.  Budgets parse as raw bytes
("123456789"), sizes ("8.6GB", "512MiB"), fractions of the dense-Adam
aux cost ("0.85x"), "floor" (the cheapest feasible plan) or "config"
(the arch's ``aux_budget_bytes``).  The model's parameter shapes come
from its ``init`` on the ``meta`` device (no allocation); ``--arch``
takes every family (the ``gqa`` and ``moe`` transformers, ``rwkv6``,
``hybrid``, ``encdec`` and ``vlm``).

``--check`` asserts, per budget: predicted bytes <= budget, predicted
bytes == the bytes of the real optimizer ``init`` (on ``meta``), and,
when the budget covers the dense cost, that the plan compresses
nothing.  Exit code 1 on any violation.
"""
from __future__ import annotations

import argparse
import json
import re

from repro_torch.plan import accounting, allocator
from repro_torch.plan.accounting import ShapeDtype
from repro_torch.plan.plan import MODE_DENSE, Plan

_SIZE_RE = re.compile(r"^([0-9.]+)\s*([KMGT]i?)?B?$", re.IGNORECASE)
_UNIT = {None: 1, "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
         "KI": 2**10, "MI": 2**20, "GI": 2**30, "TI": 2**40}

# optimizer mode -> (track_first_moment, sketch_first_moment).  dense_adam
# is absent on purpose: a sub-dense budget compresses, and a run labelled
# "dense_adam" must not be compressed behind its back.
MOMENT_MODES = {
    "cs_adam": (True, True),      # CS-MV: both moments sketched
    "cs_adam_v": (True, False),   # CS-V: dense 1st, sketched 2nd
    "cs_rmsprop": (False, False),  # β₁=0 (Theorem 5.1, extreme scale)
}


def parse_budget(text: str, *, dense_bytes: int, floor_bytes: int,
                 cfg=None) -> int:
    """Bytes of a budget string.  'config' reads ``cfg.aux_budget_bytes``
    (a model config's field)."""
    t = str(text).strip()
    if t == "floor":
        return int(floor_bytes)
    if t == "config":
        if cfg is None or getattr(cfg, "aux_budget_bytes", None) is None:
            raise ValueError("budget 'config' needs an arch whose "
                             "aux_budget_bytes is set")
        return int(cfg.aux_budget_bytes)
    if t.endswith(("x", "X")):
        return int(float(t[:-1]) * dense_bytes)
    m = _SIZE_RE.match(t)
    if not m:
        raise ValueError(f"cannot parse budget {text!r}")
    mul = _UNIT[m.group(2).upper() if m.group(2) else None]
    return int(float(m.group(1)) * mul)


def params_shapes_for_config(cfg):
    """The model's params as ``meta`` tensors: no allocation."""
    from repro_torch.train.steps import family_module
    return family_module(cfg).init(None, cfg, device="meta")


def _solve(ps, budget, *, optimizer: str, cfg=None, stats=None,
           default_alpha: float = 1.1, depth: int = 3,
           width_multiple: int = 256, sketch_dtype: str = "float32",
           seed: int = 0, shards: int = 1,
           shard_layout: str = "width") -> Plan:
    """The water-fill of ``plan_for_params`` over the shapes ``ps`` for an
    Adam-family ``optimizer``; a budget string is resolved against their
    dense cost and floor (and ``cfg`` for 'config')."""
    if optimizer not in MOMENT_MODES:
        raise ValueError(
            f"the planner executes Adam-family moment layouts only "
            f"({sorted(MOMENT_MODES)}); optimizer {optimizer!r} has no "
            f"plan mapping — run it without an aux budget")
    track, sketch_first = MOMENT_MODES[optimizer]
    kw = dict(stats=stats, default_alpha=default_alpha, depth=depth,
              width_multiple=width_multiple, sketch_dtype=sketch_dtype,
              track_first_moment=track, sketch_first_moment=sketch_first,
              shards=shards)
    if not isinstance(budget, int):
        budget = parse_budget(
            budget, dense_bytes=accounting.dense_budget_bytes(
                ps, track_first_moment=track),
            floor_bytes=allocator.min_budget_bytes(ps, **kw), cfg=cfg)
    return allocator.plan_for_params(ps, budget, seed=seed,
                                     shard_layout=shard_layout, **kw)


def plan_for_config(cfg, budget, *, optimizer: str = "cs_adam",
                    stats=None, default_alpha: float = 1.1,
                    sketch_dtype: str = "float32", seed: int = 0,
                    params_shapes=None, shards: int = 1,
                    shard_layout: str = "width") -> Plan:
    """Solve a plan against the config's real parameter shapes.
    ``budget`` is bytes or any ``parse_budget`` string; pass
    ``params_shapes`` (``params_shapes_for_config``) when planning
    several budgets."""
    ps = (params_shapes if params_shapes is not None
          else params_shapes_for_config(cfg))
    return _solve(ps, budget, optimizer=optimizer, cfg=cfg, stats=stats,
                  default_alpha=default_alpha, depth=cfg.sketch_depth,
                  sketch_dtype=sketch_dtype, seed=seed, shards=shards,
                  shard_layout=shard_layout)


def plan_for_tables(shapes, budget, *, optimizer: str = "cs_rmsprop",
                    stats=None, default_alpha: float = 1.1, depth: int = 3,
                    width_multiple: int = 256,
                    sketch_dtype: str = "float32", seed: int = 0,
                    shards: int = 1, shard_layout: str = "width") -> Plan:
    """Solve a plan for bare f32 tables, ``shapes`` mapping leaf paths to
    (rows, dim), by the same water-fill as ``plan_for_params``.
    ``budget`` is bytes or a ``parse_budget`` string ('floor' | '0.25x' |
    '512MiB'; 'config' needs an arch and is rejected).  Tables without a
    ``stats`` entry get Zipf(``default_alpha``) traffic."""
    ps = {path: ShapeDtype(tuple(int(s) for s in shape))
          for path, shape in dict(shapes).items()}
    return _solve(ps, budget, optimizer=optimizer, stats=stats,
                  default_alpha=default_alpha, depth=depth,
                  width_multiple=width_multiple, sketch_dtype=sketch_dtype,
                  seed=seed, shards=shards, shard_layout=shard_layout)


def _check(plan: Plan, budget: int, dense: int, ps) -> int:
    """Failures of one plan against its budget (printed)."""
    failures = 0
    measured = accounting.measure_aux_bytes(
        plan.make_optimizer(1e-3).init(ps))
    per_dev = plan.predicted_aux_bytes_per_device
    measured_dev = measured - plan.predicted_aux_bytes + per_dev
    ok = per_dev <= budget and measured_dev <= budget
    if not ok:
        failures += 1
        print(f"[check] FAIL: predicted {per_dev:,} / measured "
              f"{measured_dev:,} B per device > budget {budget:,} B")
    if measured != plan.predicted_aux_bytes:
        failures += 1
        ok = False
        print(f"[check] FAIL: allocator prediction "
              f"{plan.predicted_aux_bytes:,} B != measured {measured:,} B "
              f"(accounting drift)")
    if budget >= dense:
        if not all(l.mode == MODE_DENSE for l in plan.leaves):
            failures += 1
            print("[check] FAIL: dense-cost budget must reproduce the "
                  "nothing_policy dense baseline")
        elif ok:
            print("[check] OK: plan == dense baseline (no compressed "
                  "leaves)")
    elif ok:
        print(f"[check] OK: {per_dev:,} B"
              + (" per device" if plan.sketch_shards > 1 else "")
              + f" <= {budget:,} B")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--budget", default=None,
                    help="bytes | '8.6GB' | '0.85x' (of dense) | 'floor' "
                         "| 'config'")
    ap.add_argument("--budgets", default=None,
                    help="comma-separated list of budgets (plan each)")
    ap.add_argument("--optimizer", default="cs_adam",
                    choices=sorted(MOMENT_MODES))
    ap.add_argument("--alpha", type=float, default=1.1,
                    help="assumed zipf exponent for table traffic")
    ap.add_argument("--sketch-dtype", default="float32")
    ap.add_argument("--shards", type=int, default=1,
                    help="model-parallel sketch shards; the budget becomes "
                         "per-device")
    ap.add_argument("--shard-layout", default="width",
                    choices=("width", "hash"))
    ap.add_argument("--json", default=None,
                    help="write the (last) plan as JSON to this path")
    ap.add_argument("--check", action="store_true",
                    help="assert budget soundness; exit 1 on violation")
    args = ap.parse_args(argv)

    from repro_torch import configs
    cfg = configs.get(args.arch)
    track, sketch_first = MOMENT_MODES[args.optimizer]
    ps = params_shapes_for_config(cfg)
    dense = accounting.dense_budget_bytes(ps, track_first_moment=track)
    floor = allocator.min_budget_bytes(
        ps, default_alpha=args.alpha, depth=cfg.sketch_depth,
        sketch_dtype=args.sketch_dtype, track_first_moment=track,
        sketch_first_moment=sketch_first, shards=args.shards)
    shard_note = (f" shards={args.shards}({args.shard_layout})"
                  if args.shards > 1 else "")
    print(f"[plan] arch={cfg.name} optimizer={args.optimizer} "
          f"dense={dense:,} B floor={floor:,} B{shard_note}")

    budgets = ([b for b in args.budgets.split(",") if b]
               if args.budgets else [args.budget or "0.85x"])
    failures = 0
    plan = None
    for b in budgets:
        budget = parse_budget(b, dense_bytes=dense, floor_bytes=floor,
                              cfg=cfg)
        plan = plan_for_config(cfg, budget, optimizer=args.optimizer,
                               default_alpha=args.alpha,
                               sketch_dtype=args.sketch_dtype,
                               params_shapes=ps, shards=args.shards,
                               shard_layout=args.shard_layout)
        print(f"\n=== budget {b} -> {budget:,} B ===")
        print(plan.table())
        if plan.sketch_shards > 1:
            print()
            print(plan.shard_table())
        if args.check:
            failures += _check(plan, budget, dense, ps)
    if args.json and plan is not None:
        out = plan.to_json()
        # the executable vocabulary beside the plan; Plan.from_json
        # ignores the extra key
        out["store_tree"] = plan.store_tree().to_json()
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[plan] wrote {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
