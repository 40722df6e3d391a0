"""Elastic scaling and straggler mitigation (host-side control plane).

Counterpart of ``repro.distributed.elastic``.  A data-parallel step is a
synchronous program over its replicas: a straggling or dead replica
stalls them all, so the mitigation is a control loop around the step:

  * ``StragglerMonitor``: an EWMA of each host's step time, flagging
    hosts slower than ``threshold`` times the fleet median (the trainer
    records every step into it);
  * ``plan_resize`` -> ``ElasticPlan``: given the surviving devices, the
    new grid (the largest power-of-two data axis that fits, the model
    axis kept) and whether the count-sketch state must FOLD (width
    halved, Hokusai, paper §5) to fit the smaller fleet's memory;
  * ``elastic_restore``: the latest checkpoint, folded when the plan says
    so, then placed on the new grid (``shardings``): each global leaf is
    loaded, folded, and only then cut into this replica's block;
  * ``recovery_loop``: run steps, on a failure restore the latest atomic
    checkpoint and continue.  The data stream replays exactly, so the
    replayed steps are the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker with median-relative flagging."""

    threshold: float = 1.5      # flag hosts slower than 1.5x fleet median
    alpha: float = 0.2          # EWMA smoothing
    min_samples: int = 5
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _count: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (step_time if prev is None
                            else self.alpha * step_time
                            + (1 - self.alpha) * prev)
        self._count[host] = self._count.get(host, 0) + 1

    def median(self) -> Optional[float]:
        vals = sorted(self._ewma.values())
        if not vals:
            return None
        n = len(vals)
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1]
                                                 + vals[n // 2])

    def stragglers(self) -> List[int]:
        med = self.median()
        if med is None or med == 0.0:
            return []
        return sorted(
            h for h, t in self._ewma.items()
            if self._count.get(h, 0) >= self.min_samples
            and t > self.threshold * med)


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """The resize decision after losing devices: the new grid
    (``data_axis`` x ``model_axis`` x ``pods``; the model axis is kept,
    since the weights' layouts bake it in, and the data axis absorbs the
    loss) and ``fold_sketch``, whether each device's state grew enough
    that the sketches should halve their width."""

    data_axis: int
    model_axis: int
    pods: int
    fold_sketch: bool

    @property
    def chips(self) -> int:
        return self.data_axis * self.model_axis * self.pods


def plan_resize(available_chips: int, *, model_axis: int = 16,
                old_data_axis: int = 16, pods: int = 1,
                memory_headroom: float = 0.85) -> ElasticPlan:
    """The grid after failures: the model axis kept, the data axis the
    largest power of two the surviving devices fill.  When each device's
    state grows by more than 1/headroom (fewer devices hold the same
    bytes), fold the sketch."""
    if available_chips < model_axis:
        raise ValueError(f"cannot keep model_axis={model_axis} with "
                         f"{available_chips} chips")
    per_pod = available_chips // pods
    new_data = largest_pow2_leq(per_pod // model_axis)
    if new_data == 0:
        raise ValueError("not enough chips for even data=1")
    growth = old_data_axis / new_data
    return ElasticPlan(data_axis=new_data, model_axis=model_axis, pods=pods,
                       fold_sketch=growth > 1.0 / memory_headroom)


def elastic_restore(ckpt_dir, tree_like, plan: ElasticPlan, *,
                    store_tree=None, shardings=None, device="cuda",
                    is_sketch: Optional[Callable] = None):
    """The latest checkpoint restored onto a (possibly smaller) grid,
    honoring the resize decision: when ``plan.fold_sketch`` every
    count-sketch leaf is Hokusai-folded (``checkpoint.store
    .fold_sketches``), so the optimizer state survives without a reset.

    The fold predicate is exact: ``is_sketch_from_store_tree`` of
    ``store_tree`` when given, else of the tree the manifest recorded
    (the ``default_is_sketch`` name rule when it recorded none).
    ``is_sketch(path, leaf)`` overrides both; it names leaves the tree's
    rule paths cannot, such as a one-table sparse state's bare ``m`` and
    ``v``.  ``shardings`` (a ``Placement``): each leaf is loaded whole,
    folded, then cut into this replica's block.  Returns ``(step, tree,
    folded)``."""
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.distributed.sharding import place

    step, tree = ckpt.restore(ckpt_dir, tree_like,
                              device="cpu" if shardings is not None
                              else device)
    folded = bool(plan.fold_sketch)
    if folded:
        if is_sketch is not None:
            pred = is_sketch
        elif store_tree is not None:
            pred = ckpt.is_sketch_from_store_tree(store_tree)
        else:
            pred = ckpt.fold_predicate_from_manifest(
                ckpt.read_manifest(ckpt_dir, step))
        tree = ckpt.fold_sketches(tree, pred)
    if shardings is not None:
        tree = place(tree, shardings, device)
    return step, tree, folded


@dataclasses.dataclass
class RecoveryOutcome:
    steps_run: int
    restarts: int
    final_step: int


def recovery_loop(run_steps: Callable[[int, int], int],
                  restore: Callable[[], int],
                  *, total_steps: int, max_restarts: int = 10,
                  on_failure: Optional[Callable[[Exception], None]] = None
                  ) -> RecoveryOutcome:
    """Restart-on-failure driver: ``run_steps(start, total)`` runs the
    loop and returns the last completed step (raising on a failure);
    ``restore()`` reloads the latest checkpoint and returns its step.
    More than ``max_restarts`` failures re-raise the last."""
    restarts = 0
    step = restore()
    while step < total_steps:
        try:
            step = run_steps(step, total_steps)
        except Exception as e:  # noqa: BLE001 - any failure is recovered
            restarts += 1
            if on_failure is not None:
                on_failure(e)
            if restarts > max_restarts:
                raise
            step = restore()
    return RecoveryOutcome(steps_run=step, restarts=restarts, final_step=step)
