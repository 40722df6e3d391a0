"""Structured, schema-versioned JSONL metrics.

Counterpart of ``repro.obs.metrics``, the same schema: a file written by
either package validates under the other.  One run writes one
``metrics.jsonl``: a stream of flat JSON records, each carrying
``{"schema": SCHEMA_VERSION, "kind": ..., ...}``.  Kinds:

  * ``meta``  - run-level configuration, written once when the file opens;
  * ``step``  - step-keyed training scalars (loss, steps/s, dedup ratio),
    one record per ``log_every`` window, values averaged over the window;
  * ``table`` - per-table sketch health (occupancy, sign-cancellation,
    probe estimation error, planner predicted-vs-measured) from
    ``obs.probes.TableMonitor``;
  * ``phase`` - host-side phase timing (``obs.profiling.PhaseTimer``);
  * ``serve`` - serving-side adapt-latency histograms + reads/s.

The schema is enforced at both ends: ``write`` validates before
buffering, and ``validate_file`` re-validates a finished run.  Extra
numeric fields are allowed: required fields per kind are the floor, not
the ceiling.

Hot-path discipline: step metrics stay on the device inside a
``StepAccumulator`` (tensor adds on the step's own outputs, no host
sync) and are fetched ONCE per ``log_every`` window, all keys in one
copy; the writer buffers records and hits the filesystem only every
``flush_every`` records (and on close).
"""
from __future__ import annotations

import json
import math
import os
import pathlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 1

# per-kind required fields (beyond "schema"/"kind"); extras are welcome
REQUIRED_FIELDS: Dict[str, Tuple[str, ...]] = {
    "meta": ("run",),
    "step": ("step", "steps_per_s"),
    "table": ("step", "table"),
    "phase": ("step", "phases"),
    "serve": ("adapt_ms",),
}

# histogram payloads (phase spans, serve latencies) carry these keys
HISTOGRAM_FIELDS = ("count", "mean_ms", "p50_ms", "p90_ms", "p99_ms",
                    "max_ms")


class SchemaError(ValueError):
    """A record that does not conform to the metrics schema."""


def _check_value(key: str, v: Any) -> None:
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not math.isfinite(v):
            raise SchemaError(f"non-finite value for {key!r}: {v!r}")
        return
    if isinstance(v, dict):
        for k, sub in v.items():
            if not isinstance(k, str):
                raise SchemaError(f"non-string key under {key!r}: {k!r}")
            _check_value(f"{key}.{k}", sub)
        return
    if isinstance(v, (list, tuple)):
        for i, sub in enumerate(v):
            _check_value(f"{key}[{i}]", sub)
        return
    raise SchemaError(f"non-JSON value for {key!r}: {type(v).__name__}")


def validate_record(rec: Dict[str, Any]) -> None:
    """Raise ``SchemaError`` unless ``rec`` is a valid metrics record."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record is not an object: {type(rec).__name__}")
    if rec.get("schema") != SCHEMA_VERSION:
        raise SchemaError(f"unknown schema version {rec.get('schema')!r} "
                          f"(this reader speaks {SCHEMA_VERSION})")
    kind = rec.get("kind")
    if kind not in REQUIRED_FIELDS:
        raise SchemaError(f"unknown record kind {kind!r} "
                          f"(known: {sorted(REQUIRED_FIELDS)})")
    for field in REQUIRED_FIELDS[kind]:
        if field not in rec:
            raise SchemaError(f"{kind!r} record missing required field "
                              f"{field!r}")
    if "step" in rec and (not isinstance(rec["step"], int)
                          or isinstance(rec["step"], bool)
                          or rec["step"] < 0):
        raise SchemaError(f"'step' must be a non-negative int, got "
                          f"{rec['step']!r}")
    for k, v in rec.items():
        _check_value(k, v)


def validate_file(path) -> List[Dict[str, Any]]:
    """Parse + validate every record of a metrics JSONL file.  Returns the
    records; raises ``SchemaError`` (with the line number) on the first
    invalid one."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: not JSON: {e}") from e
            try:
                validate_record(rec)
            except SchemaError as e:
                raise SchemaError(f"{path}:{lineno}: {e}") from e
            records.append(rec)
    return records


class MetricsWriter:
    """Buffered JSONL writer for one run.

        with MetricsWriter("/run/dir", run_meta={"workload": ...}) as w:
            w.write("step", step=10, steps_per_s=42.0, loss=1.3)
            w.write("table", step=10, table="emb", v_occupancy=0.4)

    ``write`` validates, stamps the schema version, and buffers; the file
    is touched every ``flush_every`` records and on close.  The ``meta``
    record goes out first so every reader knows the run's configuration.
    """

    def __init__(self, out_dir, *, run_meta: Optional[Dict[str, Any]] = None,
                 filename: str = "metrics.jsonl", flush_every: int = 32):
        self.dir = pathlib.Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / filename
        self.flush_every = max(int(flush_every), 1)
        self._buf: List[str] = []
        self._n_written = 0
        self._f = open(self.path, "w")
        self.write("meta", run=dict(run_meta or {}))

    def write(self, kind: str, **fields) -> Dict[str, Any]:
        rec = {"schema": SCHEMA_VERSION, "kind": kind, **fields}
        validate_record(rec)
        self._buf.append(json.dumps(rec))
        if len(self._buf) >= self.flush_every:
            self.flush()
        return rec

    def flush(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._n_written += len(self._buf)
            self._buf.clear()
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self.flush()
        self._f.close()

    @property
    def records_written(self) -> int:
        return self._n_written + len(self._buf)

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StepAccumulator:
    """On-device aggregation of per-step metric scalars between log
    boundaries: ``add`` folds a step's metrics dict into running sums
    (tensor adds on the device, no host sync); ``drain`` fetches every
    sum in ONE copy and returns window means as host floats."""

    def __init__(self):
        self._sums: Optional[Dict[str, Any]] = None
        self._n = 0

    def add(self, metrics: Dict[str, Any]) -> None:
        if self._sums is None:
            self._sums = dict(metrics)
        else:
            self._sums = {k: self._sums[k] + v for k, v in metrics.items()
                          if k in self._sums}
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def drain(self) -> Dict[str, float]:
        """Window means as host floats.  Tensor sums are stacked (as f64,
        which holds any f32 sum exactly) and fetched in one copy."""
        import torch
        if self._sums is None:
            return {}
        keys = [k for k, v in self._sums.items()
                if isinstance(v, torch.Tensor)]
        host = {}
        if keys:
            vec = torch.stack([self._sums[k].reshape(()).to(torch.float64)
                               for k in keys]).cpu()
            host = dict(zip(keys, vec.tolist()))
        out = {k: float(host[k] if k in host else v) / self._n
               for k, v in self._sums.items()}
        self._sums, self._n = None, 0
        return out


def latest(records: Iterable[Dict[str, Any]], kind: str,
           **match) -> Optional[Dict[str, Any]]:
    """The last record of ``kind`` whose fields match ``match`` — the
    report CLI's workhorse."""
    found = None
    for rec in records:
        if rec.get("kind") != kind:
            continue
        if all(rec.get(k) == v for k, v in match.items()):
            found = rec
    return found


def default_metrics_path(metrics_dir) -> pathlib.Path:
    """Resolve a --metrics-dir / file argument to the JSONL path."""
    p = pathlib.Path(metrics_dir)
    return p if p.suffix == ".jsonl" or p.is_file() else p / "metrics.jsonl"


def run_id_from_env() -> str:
    """A stable-ish run identifier for the meta record (hostname + pid)."""
    return f"{os.uname().nodename}-{os.getpid()}"
