"""Observability: sketch-health telemetry, probes and phase profiling.

Counterpart of ``repro.obs``:

  * ``metrics``   - the schema-versioned JSONL emitter (step-keyed
    records, on-device aggregation, one host fetch a ``log_every``
    window), the reference's schema;
  * ``probes``    - shadow ground-truth probes (exact moments for K
    sampled hot/cold rows against the sketch's reads), per-store health
    gauges (``AuxStore.stats``), planner predicted-vs-measured error, and
    the ``RunObserver`` a loop drives;
  * ``profiling`` - named profiler spans, ``torch.profiler`` trace
    dumps, and p50/p99 latency histograms;
  * ``report``    - ``python -m repro_torch.obs.report``: a run's JSONL
    rendered into a health summary with re-planning warnings.
"""
from repro_torch.obs.metrics import (MetricsWriter, SCHEMA_VERSION,
                                     StepAccumulator, validate_file,
                                     validate_record)
from repro_torch.obs.probes import (RunObserver, TableMonitor, TableProbe,
                                    predicted_table_errors, rows_ema_update)
from repro_torch.obs.profiling import (LatencyTracker, PhaseTimer,
                                       maybe_trace, scope)

__all__ = [
    "MetricsWriter", "SCHEMA_VERSION", "StepAccumulator", "validate_file",
    "validate_record", "RunObserver", "TableMonitor", "TableProbe",
    "predicted_table_errors", "rows_ema_update", "LatencyTracker",
    "PhaseTimer", "maybe_trace", "scope",
]
