"""Fault-tolerant training loop.

Counterpart of ``repro.train.trainer``: a step function, the
deterministic data stream, atomic (async) checkpoints with one in
flight, straggler monitoring and crash recovery by restore.  The data
stream replays exactly, the port's colliding sums on the card add in a
fixed order, and the step counter lives on the host, so a resumed run
equals the uninterrupted one to the bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.distributed.elastic import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_async: bool = True
    keep: int = 3
    log_every: int = 10
    host_id: int = 0


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def wait_for(t: torch.Tensor) -> None:
    """Block the host until ``t`` and all the work queued before it on
    its stream are done; other streams (an async cleaner's, a
    checkpoint's) are not waited on.  The reference blocks on the step's
    loss the same way."""
    if t.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()


class Trainer:
    """``fit`` runs [start, total); checkpoints; records step times.

    ``plan``: an optional ``repro_torch.plan.Plan`` executing on this
    run; the plan and its ``StoreTree`` are recorded in every checkpoint
    manifest, and ``restore_or_init`` recovers a recorded plan.
    ``store_tree``: record an executable ``StoreTree`` for a run with no
    plan.  ``observer``: an optional ``repro_torch.obs.RunObserver``
    given every step's host record and, at its boundaries, the live
    optimizer state; ``fit`` closes it when it completes.  ``cleaner``:
    an optional ``core.cleaning.AsyncCleaner`` dispatched between steps.
    ``fail_at``: a test hook that raises once when the loop reaches that
    step.  Batches go to ``device`` as tensors.  ``shardings``: a
    ``distributed.sharding.Placement`` of ``{"params", "opt_state"}``
    when the state is one replica's blocks on a mesh: checkpoints gather
    the global leaves and the mesh's origin writes them
    (``checkpoint.store.save``), and ``restore_or_init`` loads this
    replica's blocks; every replica runs the same ``Trainer``."""

    def __init__(self, step_fn: Callable, data, tcfg: TrainerConfig,
                 monitor: Optional[StragglerMonitor] = None,
                 fail_at: Optional[int] = None, plan=None,
                 store_tree=None, observer=None, cleaner=None,
                 device="cuda", shardings=None):
        self.step_fn = step_fn
        self.data = data
        self.tcfg = tcfg
        self.monitor = monitor or StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self.plan = plan
        self.store_tree = store_tree
        self.observer = observer
        self.cleaner = cleaner
        self.device = torch.device(device)
        if plan is not None and store_tree is not None \
                and plan.store_tree() != store_tree:
            raise ValueError("Trainer got both a plan and a store_tree "
                             "that disagree; the manifest must record "
                             "ONE executable vocabulary")
        self.shardings = shardings
        self._fail_at = fail_at
        self._pending_ckpt = None

    def _maybe_checkpoint(self, state: TrainState, force: bool = False):
        t = self.tcfg
        if t.ckpt_dir is None:
            return
        if force or (state.step % t.ckpt_every == 0 and state.step > 0):
            if self._pending_ckpt is not None:
                self._pending_ckpt.join()     # backpressure: one in flight
            tree = {"params": state.params, "opt_state": state.opt_state}
            extra = None
            if self.plan is not None:
                extra = {"plan": self.plan.to_json(),
                         "store_tree": self.plan.store_tree().to_json()}
            elif self.store_tree is not None:
                extra = {"store_tree": self.store_tree.to_json()}
            self._pending_ckpt = store.save(
                t.ckpt_dir, state.step, tree,
                async_=t.ckpt_async, keep=t.keep, extra=extra,
                shardings=self.shardings)

    def restore_or_init(self, init_state: TrainState,
                        shardings=None) -> TrainState:
        t = self.tcfg
        if t.ckpt_dir is None or store.latest_step(t.ckpt_dir) is None:
            return init_state
        tree_like = {"params": init_state.params,
                     "opt_state": init_state.opt_state}
        step, tree = store.restore(
            t.ckpt_dir, tree_like, device=self.device,
            shardings=shardings if shardings is not None else self.shardings)
        if self.plan is None:
            saved = store.read_manifest(t.ckpt_dir, step).get("extra", {})
            if saved.get("plan") is not None:
                from repro_torch.plan import Plan
                self.plan = Plan.from_json(saved["plan"])
        return TrainState(step=step, params=tree["params"],
                          opt_state=tree["opt_state"])

    def _obs_phase(self, name: str):
        if self.observer is None:
            return contextlib.nullcontext()
        return self.observer.phase(name)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def fit(self, state: TrainState) -> TrainState:
        t = self.tcfg
        while state.step < t.total_steps:
            if self._fail_at is not None and state.step == self._fail_at:
                self._fail_at = None          # fail once
                raise RuntimeError(f"injected failure at step {state.step}")
            with self._obs_phase("data"):
                batch = self._to_device(self.data.batch(state.step))
            if self.cleaner is not None:
                with self._obs_phase("clean"):
                    # the upcoming step observes counter state.step + 1
                    opt_state, _ = self.cleaner.maybe_dispatch(
                        state.opt_state, state.step + 1)
                    state = TrainState(step=state.step,
                                       params=state.params,
                                       opt_state=opt_state)
            t0 = time.perf_counter()
            with self._obs_phase("step"):
                params, opt_state, metrics = self.step_fn(
                    state.params, state.opt_state, batch)
                wait_for(metrics["loss"])
            dt = time.perf_counter() - t0
            self.monitor.record(t.host_id, dt)
            state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
            rec = {"step": state.step, "time_s": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            self.history.append(rec)
            if self.observer is not None:
                self.observer.on_step(state.step, rec, state.opt_state)
            with self._obs_phase("checkpoint"):
                self._maybe_checkpoint(state)
        with self._obs_phase("checkpoint"):
            self._maybe_checkpoint(state, force=True)
            if self._pending_ckpt is not None:
                self._pending_ckpt.join()
        if self.observer is not None:
            self.observer.close(state.step, state.opt_state)
        return state
