"""Memory-budget planner: "spend at most B bytes on optimizer state" ->
an executable per-leaf compression plan.

Counterpart of ``repro.plan``:

    from repro_torch.plan import plan_for_params, Plan

    plan = plan_for_params(params, budget_bytes)      # solve
    print(plan.table())                               # inspect
    opt = plan.make_optimizer(lr=1e-3, backend="auto")  # execute
    extra = {"plan": plan.to_json()}                  # persist

Modules: ``accounting`` (predicted and measured aux bytes),
``error_model`` (CMS/CS collision error under power-law traffic),
``allocator`` (greedy water-filling over width ladders), ``plan`` (the
executable ``Plan`` and its JSON), ``cli`` (budget strings,
``plan_for_tables``, ``plan_for_config`` for a registry model and the
``--arch`` command line).
"""
from repro_torch.plan.accounting import (  # noqa: F401
    ShapeDtype, dense_budget_bytes, measure_aux_bytes, predict_policy_bytes)
from repro_torch.plan.allocator import (  # noqa: F401
    leaf_candidates, min_budget_bytes, plan_for_params, water_fill)
from repro_torch.plan.cli import (  # noqa: F401
    MOMENT_MODES, params_shapes_for_config, parse_budget, plan_for_config,
    plan_for_tables)
from repro_torch.plan.error_model import TableStats, measure_freqs  # noqa: F401
from repro_torch.plan.plan import (  # noqa: F401
    InfeasibleBudgetError, LeafPlan, Plan, MODE_DENSE, MODE_RANK1,
    MODE_SKETCH)
