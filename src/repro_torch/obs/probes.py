"""Online sketch estimation-error probes + the run observer.

Counterpart of ``repro.obs.probes``.

**Shadow ground-truth probes** (``TableProbe``).  For K sampled rows of
a sketched table - half *hot* (the zipf head, rows 0..K/2-1) and half
*cold* (spread through the tail, where collision noise concentrates) -
keep EXACT dense moments as a (K, d) shadow, updated every step with the
same dedup-summed, touched-rows-only EMA the sparse-rows kernels apply:

    m_p <- b1*m_p + (1-b1)*sum_{ids==p} g        (touched rows only)
    v_p <- b2*v_p + (1-b2)*(sum_{ids==p} g)^2

At each log boundary the monitor compares ``store.read(state,
rows=probe_ids)`` against the shadow: the relative L1 gap is the
realized estimation error of the sketch at those rows (exactly zero for
a ``DenseStore``).

**Per-table monitors** (``TableMonitor``) bundle the probe with the
stores' ``stats`` gauges, the error-feedback residual norm and the
planner's predicted error into one ``table`` record per log interval.
``collect`` keeps the reference's one-boundary lag: it stacks every
scalar into one device vector, starts a ``non_blocking`` copy into
pinned host memory, records a CUDA event, and materializes the vector
at the next boundary (or ``flush``).  Nothing here synchronizes between
boundaries.

**RunObserver** is the host-side hub a training loop drives: it windows
per-step scalars, computes steps/s, and emits ``step``/``table``/
``phase`` records at ``log_every`` boundaries.

Shadow, probe and store states are updated IN PLACE and returned.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import dedup
from repro_torch.obs.metrics import MetricsWriter
from repro_torch.obs.profiling import PhaseTimer

_TINY = 1e-12


def probe_row_ids(n_rows: int, k: int = 16) -> Tuple[int, ...]:
    """K probe rows: the first ceil(k/2) ids (the zipf head - hot rows)
    plus floor(k/2) ids geometrically spread through the tail (cold
    rows).  Deterministic, the reference's selection."""
    k = max(min(int(k), n_rows), 1)
    n_hot = (k + 1) // 2
    hot = list(range(n_hot))
    n_cold = k - n_hot
    cold: List[int] = []
    if n_cold > 0:
        lo, hi = n_hot, max(n_rows - 1, n_hot)
        pts = np.unique(np.geomspace(lo + 1, hi + 1, num=n_cold * 4)
                        .astype(np.int64) - 1)
        pts = [int(p) for p in pts if p >= n_hot]
        stride = max(len(pts) // n_cold, 1)
        cold = pts[::stride][:n_cold]
        while len(cold) < n_cold:                 # tiny tables: pad forward
            nxt = (cold[-1] + 1) if cold else n_hot
            if nxt >= n_rows:
                break
            cold.append(nxt)
    return tuple(hot + cold)


@functools.lru_cache(maxsize=64)
def _ids_on(ids: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The probe ids as an int32 tensor on ``device``, copied once per
    device (a copy to a card waits for it, so ``init`` makes it)."""
    return torch.tensor(ids, dtype=torch.int32, device=device)


def _masked_mean(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``e`` over ``mask``; nan where the mask is empty."""
    c = mask.sum()
    return torch.where(c > 0, (e * mask).sum() / torch.clamp_min(c, 1.0),
                       float("nan"))


@dataclasses.dataclass(frozen=True)
class TableProbe:
    """Shadow ground-truth probe for one (n, d) table's moment pair.

    ``update`` is called with every step's (ids, grad_rows) batch and
    stays on the device; the probe state ``{"pm", "pv", "hits"}`` rides
    beside the run's optimizer state (under a ``"probe"`` key for
    ``TableMonitor``'s default getter)."""

    path: str
    probe_ids: Tuple[int, ...]
    b1: float = 0.9
    b2: float = 0.999
    track_first_moment: bool = True

    @classmethod
    def for_table(cls, path: str, n_rows: int, *, k: int = 16,
                  b1: float = 0.9, b2: float = 0.999,
                  track_first_moment: bool = True) -> "TableProbe":
        return cls(path=path, probe_ids=probe_row_ids(n_rows, k), b1=b1,
                   b2=b2, track_first_moment=track_first_moment)

    @property
    def k(self) -> int:
        return len(self.probe_ids)

    def pids(self, device) -> torch.Tensor:
        return _ids_on(self.probe_ids, torch.device(device))

    def init(self, dim: int, device="cuda"):
        self.pids(device)
        zeros = lambda: torch.zeros((self.k, int(dim)),  # noqa: E731
                                    dtype=torch.float32, device=device)
        return {"pm": zeros() if self.track_first_moment else None,
                "pv": zeros(),
                "hits": torch.zeros((self.k,), dtype=torch.int32,
                                    device=device)}

    def update(self, pstate, ids, grad_rows):
        """One shadow EMA step from a raw (duplicate-carrying) (ids, rows)
        batch, IN PLACE: duplicates of a probe id are summed first, as the
        dedup pre-pass sums them for the kernels."""
        pids = self.pids(ids.device)
        hit = (ids[None, :] == pids[:, None]).to(torch.float32)  # (K, k)
        gsum = hit @ grad_rows.to(torch.float32)                 # (K, d)
        touched = hit.sum(dim=1) > 0
        t = touched[:, None].to(torch.float32)
        if pstate.get("pm") is not None:
            pm = pstate["pm"]
            pm.add_(t * (1.0 - self.b1) * (gsum - pm))
        pv = pstate["pv"]
        pv.add_(t * (1.0 - self.b2) * (gsum * gsum - pv))
        pstate["hits"].add_(touched.to(torch.int32))
        return pstate

    def errors_device(self, pstate, *, m_store=None, m_state=None,
                      v_store=None, v_state=None) -> Dict[str, Any]:
        """The estimation-error comparison as device scalars: per-moment
        mean relative L1 error of ``store.read`` at the probe rows vs the
        shadow, over the rows the stream touched, the v error split into
        hot and cold halves.  Rows not yet seen give ``nan`` scalars
        (the host side drops non-finite fields)."""
        dev = pstate["pv"].device
        pids = self.pids(dev)
        seen = (pstate["hits"] > 0).to(torch.float32)
        out: Dict[str, Any] = {"probe_rows_seen": seen.sum()}

        def rel_err(est, shadow):
            num = (est.to(torch.float32)
                   - shadow.to(torch.float32)).abs().sum(dim=1)
            den = shadow.to(torch.float32).abs().sum(dim=1) + _TINY
            return num / den

        n_hot = (self.k + 1) // 2
        pos = torch.arange(self.k, device=dev)
        hot = seen * (pos < n_hot)
        cold = seen * (pos >= n_hot)

        def quant_noise(store, state, shadow):
            """Expected relative-L1 share of int8 cell quantization at the
            probe rows: E|SR noise| is scale/4 a cell, reduced over depth
            as the estimator reduces (min for count-min, mean for the
            signed median).  It widens the ``*_error_ratio`` envelope."""
            spec = getattr(store, "spec", None)
            if spec is None or not getattr(spec, "quantized", False):
                return None
            b = spec.family.bucket(pids)
            sc = qz.bucket_scales(state.scales, b, spec.scale_block)
            s_row = sc.mean(dim=0) if spec.signed else sc.min(dim=0).values
            num = shadow.shape[1] * s_row / 4.0
            den = shadow.to(torch.float32).abs().sum(dim=1) + _TINY
            return _masked_mean(num / den, seen)

        if m_store is not None and pstate.get("pm") is not None:
            e = rel_err(m_store.read(m_state, rows=pids), pstate["pm"])
            out["m_meas_error"] = _masked_mean(e, seen)
            qn = quant_noise(m_store, m_state, pstate["pm"])
            if qn is not None:
                out["m_quant_noise"] = qn
        if v_store is not None:
            e = rel_err(v_store.read(v_state, rows=pids), pstate["pv"])
            out["v_meas_error"] = _masked_mean(e, seen)
            out["v_meas_error_hot"] = _masked_mean(e, hot)
            out["v_meas_error_cold"] = _masked_mean(e, cold)
            qn = quant_noise(v_store, v_state, pstate["pv"])
            if qn is not None:
                out["v_quant_noise"] = qn
        return out

    def errors(self, pstate, *, m_store=None, m_state=None,
               v_store=None, v_state=None) -> Dict[str, float]:
        """Host-facing form of ``errors_device``: one device fetch, nan
        (not-yet-seen) fields dropped, plus the static probe-row count."""
        dev = self.errors_device(pstate, m_store=m_store, m_state=m_state,
                                 v_store=v_store, v_state=v_state)
        keys = list(dev)
        vals = torch.stack([dev[k].reshape(()).to(torch.float32)
                            for k in keys]).cpu().tolist()
        out: Dict[str, float] = {"probe_rows": int(self.k)}
        for k, f in zip(keys, vals):
            if np.isfinite(f):
                out[k] = int(f) if k == "probe_rows_seen" else f
        return out


def rows_ema_update(store, state, ids, rows_delta, beta: float,
                    *, square: bool = False):
    """One touched-rows EMA step (row <- beta*row + (1-beta)*delta)
    through any store, IN PLACE: the dedup + masked ``ema_delta`` form the
    adam_rows kernels apply, the semantics the probe shadow replicates.
    ``square=True`` squares the DEDUP-SUMMED rows (the v-moment
    semantics: (sum g)^2, not sum g^2)."""
    db = dedup.dedup_rows(ids, rows_delta)
    mask = db.mask
    uids = torch.where(mask > 0, db.unique_ids, 0)
    target = db.rows * db.rows if square else db.rows
    est_old = store.read(state, rows=uids)
    d = (1.0 - beta) * (target - est_old) * mask[:, None]
    return store.accumulate(state, d, rows=uids)


def predicted_table_errors(m_store, v_store, n_rows: int, *,
                           alpha: float = 1.1,
                           freqs=None) -> Dict[str, float]:
    """The planner's model error for this table's bound store pair,
    ``plan.error_model`` at the stores' (depth, width), so runs without a
    solved plan still get a predicted-vs-measured comparison."""
    from repro_torch.plan.error_model import (TableStats, countmin_error,
                                              countsketch_error)
    stats = TableStats(alpha=alpha, freqs=freqs)
    out: Dict[str, float] = {}

    def one(store) -> Optional[float]:
        if store is None:
            return None
        if store.kind == "dense":
            return 0.0
        spec = getattr(store, "spec", None)
        if spec is None:
            return None
        fn = countsketch_error if spec.signed else countmin_error
        return float(fn(stats, n_rows, spec.width, spec.depth))

    m_err, v_err = one(m_store), one(v_store)
    if m_err is not None:
        out["m_pred_error"] = m_err
    if v_err is not None:
        out["v_pred_error"] = v_err
    return out


@dataclasses.dataclass
class TableMonitor:
    """Everything the observer emits about ONE table per log interval.

    ``getter`` maps the run's opt_state to this table's state dict with
    keys ``"m"``/``"v"`` (moment states), optional ``"residual"`` and
    ``"probe"`` (the shadow state); the default is the opt_state itself.
    ``cleaner`` (an ``AsyncCleaner``): while its decay is in flight at a
    boundary, the record's ``v_clean_next_removes`` is zeroed."""

    path: str
    m_store: Any = None
    v_store: Any = None
    probe: Optional[TableProbe] = None
    predicted: Dict[str, float] = dataclasses.field(default_factory=dict)
    getter: Optional[Callable[[Any], Dict[str, Any]]] = None
    cleaner: Any = None
    _last_step: int = dataclasses.field(default=0, repr=False)
    _keys: Optional[Tuple[str, ...]] = dataclasses.field(default=None,
                                                         repr=False)
    _host: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                      repr=False)
    # (step, window_start, event or None, clean_pending) dispatched at the
    # previous boundary, materialized at the next one
    _pending: Any = dataclasses.field(default=None, repr=False)

    def _states(self, opt_state) -> Dict[str, Any]:
        if self.getter is not None:
            return self.getter(opt_state)
        return opt_state

    def _device_collect(self, st: Dict[str, Any]) -> Dict[str, Any]:
        """Store stats, residual norm and probe errors as device
        scalars."""
        payload: Dict[str, Any] = {}
        for slot, store in (("m", self.m_store), ("v", self.v_store)):
            state = st.get(slot)
            if store is None or state is None:
                continue
            for k, v in store.stats(state).items():
                payload[f"{slot}_{k}"] = v
        if st.get("residual") is not None:
            payload["residual_l1"] = st["residual"].abs().sum()
        if self.probe is not None and st.get("probe") is not None:
            payload.update(self.probe.errors_device(
                st["probe"],
                m_store=self.m_store, m_state=st.get("m"),
                v_store=self.v_store, v_state=st.get("v")))
        return payload

    def collect(self, opt_state, step: int) -> Optional[Dict[str, Any]]:
        """Dispatch this boundary's device stats and return the payload of
        the PREVIOUS boundary (``None`` on the first; ``flush()`` drains
        the last).  The stats are stacked into one vector whose copy to
        pinned host memory is queued behind the in-flight step, with an
        event after it; records carry the step they measured, so the lag
        only delays file writes."""
        out = self.flush()
        payload = self._device_collect(self._states(opt_state))
        keys = tuple(sorted(payload))
        if self._keys is None:
            self._keys = keys
        elif keys != self._keys:
            raise ValueError(f"table {self.path!r}: the stats keys changed "
                             f"between boundaries: {self._keys} -> {keys}")
        vec = torch.stack([payload[k].reshape(()).to(torch.float32)
                           for k in keys])
        event = None
        if vec.device.type == "cuda":
            if self._host is None or self._host.numel() != len(keys):
                self._host = torch.empty((len(keys),), dtype=torch.float32,
                                         pin_memory=True)
            self._host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            self._host = vec
        pending_clean = (self.cleaner is not None
                         and self.cleaner.in_flight())
        self._pending = (int(step), self._last_step, event, pending_clean)
        self._last_step = int(step)
        return out

    def flush(self) -> Optional[Dict[str, Any]]:
        """Materialize the pending boundary's payload (waits on its event
        only), or ``None`` when nothing is pending.  Non-finite scalars
        (probe slots not yet touched) are dropped: the schema forbids
        them."""
        if self._pending is None:
            return None
        step, win_start, event, pending_clean = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        dev = dict(zip(self._keys, self._host.tolist()))
        payload: Dict[str, Any] = {"step": step, "table": self.path}
        for slot, store in (("m", self.m_store), ("v", self.v_store)):
            name = getattr(store, "cell_dtype_name", None)
            if name is not None and name != "float32":
                payload[f"{slot}_cell_dtype"] = name
        if self.probe is not None:
            payload["probe_rows"] = int(self.probe.k)
        for k, f in dev.items():
            if np.isfinite(f):
                payload[k] = int(f) if k == "probe_rows_seen" else f
        payload.update(self.predicted)
        # measured / predicted: the re-planning signal (>> 1: traffic is
        # harder than the plan's zipf model); int8 cells widen the
        # envelope by the probe's quantization-noise gauge
        for slot in ("m", "v"):
            pred = payload.get(f"{slot}_pred_error")
            meas = payload.get(f"{slot}_meas_error")
            if pred is not None and meas is not None:
                env = pred + payload.get(f"{slot}_quant_noise", 0.0)
                payload[f"{slot}_error_ratio"] = meas / max(env, _TINY)
        if self.v_store is not None and hasattr(self.v_store,
                                               "cleans_between"):
            payload["cleans_in_window"] = self.v_store.cleans_between(
                win_start, step)
        if pending_clean and "v_clean_next_removes" in payload:
            payload["v_clean_next_removes"] = 0.0
        return payload


class RunObserver:
    """The host-side hub between a training loop and the metrics file.

        obs = RunObserver(writer, monitors=[...], log_every=10)
        ...
        obs.on_step(step, rec, opt_state)   # every step, host scalars
        obs.close(final_step, opt_state)    # flush the trailing window

    Per-step cost is appending the host floats the loop already has;
    device state is touched only at ``log_every`` boundaries."""

    def __init__(self, writer: MetricsWriter,
                 monitors: Sequence[TableMonitor] = (),
                 log_every: int = 10,
                 phase_timer: Optional[PhaseTimer] = None):
        self.writer = writer
        self.monitors = list(monitors)
        self.log_every = max(int(log_every), 1)
        self.phase_timer = phase_timer
        self._window: List[Dict[str, float]] = []
        self._emitted_at: Optional[int] = None

    def phase(self, name: str):
        """Host-side span (no-op without a phase timer)."""
        if self.phase_timer is None:
            return contextlib.nullcontext()
        return self.phase_timer.phase(name)

    def on_step(self, step: int, rec: Dict[str, float],
                opt_state=None) -> None:
        self._window.append(rec)
        if step % self.log_every == 0:
            self._emit(step, opt_state)

    def _emit(self, step: int, opt_state) -> None:
        if not self._window:
            return
        keys = set().union(*(r.keys() for r in self._window)) - {"step"}
        means = {k: float(np.mean([r[k] for r in self._window if k in r]))
                 for k in sorted(keys)}
        wall = means.pop("time_s", 0.0)
        self.writer.write(
            "step", step=int(step),
            steps_per_s=round(1.0 / wall, 4) if wall > 0 else 0.0,
            window=len(self._window), **{
                k: round(v, 8) for k, v in means.items()})
        self._window.clear()
        if opt_state is not None:
            for mon in self.monitors:
                rec = mon.collect(opt_state, int(step))
                if rec is not None:
                    self.writer.write("table", **rec)
        if self.phase_timer is not None:
            phases = self.phase_timer.drain()
            if phases:
                self.writer.write("phase", step=int(step), phases=phases)
        self._emitted_at = int(step)

    def close(self, final_step: Optional[int] = None,
              opt_state=None) -> None:
        """Flush a trailing partial window, each monitor's pending
        boundary, and the writer."""
        if self._window and final_step is not None \
                and final_step != self._emitted_at:
            self._emit(final_step, opt_state)
        for mon in self.monitors:
            rec = mon.flush()
            if rec is not None:
                self.writer.write("table", **rec)
        self.writer.close()
