"""Budget strings and the table planner.

Counterpart of the parts of ``repro.plan.cli`` that need no model
registry: ``parse_budget``, ``MOMENT_MODES`` and ``plan_for_tables``.
Budgets parse as raw bytes ("123456789"), sizes ("8.6GB", "512MiB"),
fractions of the dense-Adam aux cost ("0.85x") or "floor" (the cheapest
feasible plan).  Planning a registry model (``--arch``:
``params_shapes_for_config``, ``plan_for_config``, ``main``) builds the
model's parameter shapes and waits for the LM stack (ROADMAP A14).
"""
from __future__ import annotations

import re

from repro_torch.plan import accounting, allocator
from repro_torch.plan.accounting import ShapeDtype
from repro_torch.plan.plan import Plan

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


def _needs_lm_stack(name: str):
    raise NotImplementedError(
        f"{name} builds a registry model's parameter shapes, which waits "
        f"for the LM stack (ROADMAP A14); plan bare tables with "
        f"plan_for_tables or a parameter tree with plan_for_params")


def params_shapes_for_config(cfg):
    _needs_lm_stack("params_shapes_for_config")


def plan_for_config(cfg, budget, **kw) -> Plan:
    _needs_lm_stack("plan_for_config")


def main(argv=None) -> int:
    _needs_lm_stack("the plan CLI (--arch)")


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
    if optimizer not in MOMENT_MODES:
        raise ValueError(
            f"the planner executes Adam-family moment layouts only "
            f"({sorted(MOMENT_MODES)}); optimizer {optimizer!r} has no "
            f"plan mapping — run it without an aux budget")
    track, sketch_first = MOMENT_MODES[optimizer]
    ps = {path: ShapeDtype(tuple(int(s) for s in shape))
          for path, shape in dict(shapes).items()}
    if not isinstance(budget, int):
        dense = accounting.dense_budget_bytes(ps, track_first_moment=track)
        floor = allocator.min_budget_bytes(
            ps, stats=stats, default_alpha=default_alpha, depth=depth,
            width_multiple=width_multiple, sketch_dtype=sketch_dtype,
            track_first_moment=track, sketch_first_moment=sketch_first,
            shards=shards)
        budget = parse_budget(budget, dense_bytes=dense, floor_bytes=floor)
    return allocator.plan_for_params(
        ps, budget, stats=stats, default_alpha=default_alpha, depth=depth,
        width_multiple=width_multiple, sketch_dtype=sketch_dtype, seed=seed,
        track_first_moment=track, sketch_first_moment=sketch_first,
        shards=shards, shard_layout=shard_layout)
