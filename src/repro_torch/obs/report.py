"""``python -m repro_torch.obs.report <metrics.jsonl | run-dir>`` - render
a run's metrics stream into a terminal health summary.

Counterpart of ``repro.obs.report``: the same digest, warnings,
thresholds and ``--strict`` exit codes, on files of either package.

Sections: run meta, training trajectory (steps/s, loss first→last), one
block per table (occupancy, sign-cancellation, probe measured error vs
planner predicted error, cleaning cadence), phase timing, and serve
latency.  After the summary, WARNINGS:

  * ``saturation`` — sketch occupancy above ``--occupancy-warn`` (0.85):
    nearly every cell is live, collision error grows past the model —
    re-plan at a larger width.
  * ``plan-model`` — measured probe error above ``--ratio-warn`` (3.0) ×
    the planner's prediction: realized traffic is heavier-tailed than
    the zipf assumption; the plan's error budget is not being met.
  * ``probe-error`` — measured error above ``--error-warn`` (0.5):
    estimates at the probe rows are mostly collision noise.
  * ``serve-slo`` — serve-side adapt p99 above the SLO target the record
    carries (``slo_p99_ms``, from the server's config) or, failing that,
    ``--serve-p99-warn``: the adaptation path is violating its latency
    budget.
  * ``serve-shed`` — nonzero shed rate: the admission queue overflowed
    at the offered load; requests were rejected, not just delayed.
  * ``shard-imbalance`` — a sharded sketch's per-shard occupancy spread
    (``shard_occ_max / shard_occ_min``, from the store's per-shard
    gauges) above ``--shard-imbalance-warn`` (2.0): one shard is doing
    most of the colliding while others sit near-empty — the hash-layout
    owner hash is skewed for this id distribution (or the width layout's
    slab boundaries landed badly); re-seed or re-plan.

``--strict`` exits 1 when any warning fires.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from repro_torch.obs.metrics import default_metrics_path, validate_file


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table_rows(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Latest ``table`` record per table path."""
    out: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") == "table":
            out[rec["table"]] = rec
    return out


def analyze(records: List[Dict[str, Any]], *, occupancy_warn: float = 0.85,
            ratio_warn: float = 3.0, error_warn: float = 0.5,
            serve_p99_warn: float = 0.0,
            shard_imbalance_warn: float = 2.0,
            ) -> Dict[str, Any]:
    """Digest a validated record stream into summary + warnings (pure —
    unit-testable without touching the filesystem)."""
    steps = [r for r in records if r.get("kind") == "step"]
    serves = [r for r in records if r.get("kind") == "serve"]
    phases = [r for r in records if r.get("kind") == "phase"]
    meta = next((r for r in records if r.get("kind") == "meta"), None)
    tables = _table_rows(records)

    warnings: List[str] = []
    for path, rec in sorted(tables.items()):
        for slot in ("m", "v"):
            occ = rec.get(f"{slot}_occupancy")
            if occ is not None and occ > occupancy_warn \
                    and rec.get(f"{slot}_pred_error", 1.0) != 0.0:
                warnings.append(
                    f"saturation: {path}.{slot} occupancy {occ:.2f} > "
                    f"{occupancy_warn:.2f} — collisions past the model; "
                    f"re-plan at a larger width")
            ratio = rec.get(f"{slot}_error_ratio")
            if ratio is not None and ratio > ratio_warn:
                warnings.append(
                    f"plan-model: {path}.{slot} measured error "
                    f"{rec.get(f'{slot}_meas_error', 0.0):.3g} is "
                    f"{ratio:.1f}x the planner's prediction "
                    f"{rec.get(f'{slot}_pred_error', 0.0):.3g} — traffic "
                    f"heavier-tailed than the plan's zipf model")
            meas = rec.get(f"{slot}_meas_error")
            if meas is not None and meas > error_warn:
                warnings.append(
                    f"probe-error: {path}.{slot} measured estimation error "
                    f"{meas:.3g} > {error_warn:.2g} — estimates at probe "
                    f"rows are mostly collision noise")
            lo = rec.get(f"{slot}_shard_occ_min")
            hi = rec.get(f"{slot}_shard_occ_max")
            if lo is not None and hi is not None and hi > 0.0 \
                    and hi > shard_imbalance_warn * max(lo, 1e-9):
                warnings.append(
                    f"shard-imbalance: {path}.{slot} per-shard occupancy "
                    f"{lo:.3f} .. {hi:.3f} "
                    f"({hi / max(lo, 1e-9):.1f}x spread > "
                    f"{shard_imbalance_warn:.1f}x) — one slab is doing "
                    f"most of the colliding; re-seed the owner hash or "
                    f"re-plan the width")

    if serves:
        last = serves[-1]
        p99 = (last.get("adapt_ms") or {}).get("p99_ms")
        slo = last.get("slo_p99_ms", serve_p99_warn or None)
        if p99 is not None and slo and p99 > slo:
            warnings.append(
                f"serve-slo: adapt p99 {p99:.2f} ms > SLO {slo:.2f} ms — "
                f"the adaptation path is violating its latency budget")
        shed = last.get("shed_rate", 0.0)
        if shed and shed > 0:
            warnings.append(
                f"serve-shed: {shed:.1%} of requests shed "
                f"({last.get('n_shed', '?')}/{last.get('n_requests', '?')}) "
                f"— admission queue overflowed at the offered load; scale "
                f"out, raise queue_cap, or shed earlier upstream")

    return {"meta": meta, "steps": steps, "tables": tables,
            "phases": phases, "serves": serves, "warnings": warnings}


def render(digest: Dict[str, Any], out=sys.stdout) -> None:
    p = lambda *a: print(*a, file=out)  # noqa: E731
    meta = digest["meta"]
    p("== run ==")
    if meta:
        for k, v in sorted((meta.get("run") or {}).items()):
            p(f"  {k}: {_fmt(v)}")

    steps = digest["steps"]
    if steps:
        first, last = steps[0], steps[-1]
        sps = [r["steps_per_s"] for r in steps if r.get("steps_per_s", 0) > 0]
        p("== training ==")
        p(f"  steps: {first['step']} .. {last['step']} "
          f"({len(steps)} windows)")
        if sps:
            p(f"  steps/s: mean {sum(sps) / len(sps):.2f}  last {sps[-1]:.2f}")
        if "loss" in first and "loss" in last:
            p(f"  loss: {first['loss']:.4g} -> {last['loss']:.4g}")
        if "dedup_ratio" in last:
            p(f"  dedup unique-id ratio (last): {last['dedup_ratio']:.3f}")

    for path, rec in sorted(digest["tables"].items()):
        p(f"== table {path} (step {rec['step']}) ==")
        for slot in ("m", "v"):
            fields = [(k, rec[k]) for k in sorted(rec)
                      if k.startswith(f"{slot}_")]
            if fields:
                p(f"  [{slot}] " + "  ".join(
                    f"{k[len(slot) + 1:]}={_fmt(v)}" for k, v in fields))
        extras = [(k, rec[k]) for k in ("residual_l1", "probe_rows",
                                        "probe_rows_seen",
                                        "cleans_in_window") if k in rec]
        if extras:
            p("  " + "  ".join(f"{k}={_fmt(v)}" for k, v in extras))

    if digest["phases"]:
        last = digest["phases"][-1]
        p(f"== phases (step {last['step']}) ==")
        for name, h in sorted(last["phases"].items()):
            p(f"  {name}: {h['count']}x  mean {h['mean_ms']:.3f} ms")

    if digest["serves"]:
        last = digest["serves"][-1]
        h = last["adapt_ms"]
        p("== serve ==")
        p(f"  adapt latency: p50 {h['p50_ms']:.3f} ms  "
          f"p99 {h['p99_ms']:.3f} ms  ({h['count']} adapts)")
        if "reads_per_s" in last:
            p(f"  adapts/s: {last['reads_per_s']:.1f}")
        rq = last.get("request_ms")
        if rq and rq.get("count"):
            p(f"  request latency (queueing incl.): p50 {rq['p50_ms']:.3f} "
              f"ms  p99 {rq['p99_ms']:.3f} ms")
        if "shed_rate" in last:
            p(f"  shed: {last.get('n_shed', 0)}/{last.get('n_requests', 0)} "
              f"({last['shed_rate']:.1%})  batches: "
              f"{last.get('n_batches', 0)}")

    if digest["warnings"]:
        p("== WARNINGS ==")
        for w in digest["warnings"]:
            p(f"  ! {w}")
    else:
        p("== healthy: no warnings ==")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="metrics.jsonl or the run dir holding it")
    ap.add_argument("--occupancy-warn", type=float, default=0.85)
    ap.add_argument("--ratio-warn", type=float, default=3.0)
    ap.add_argument("--error-warn", type=float, default=0.5)
    ap.add_argument("--serve-p99-warn", type=float, default=0.0,
                    help="fallback serve p99 SLO (ms) for records that "
                         "carry no slo_p99_ms of their own; 0 disables")
    ap.add_argument("--shard-imbalance-warn", type=float, default=2.0,
                    help="warn when a sharded sketch's per-shard occupancy "
                         "max exceeds this multiple of its min")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any warning fires")
    args = ap.parse_args(argv)

    path = default_metrics_path(args.path)
    records = validate_file(path)
    digest = analyze(records, occupancy_warn=args.occupancy_warn,
                     ratio_warn=args.ratio_warn, error_warn=args.error_warn,
                     serve_p99_warn=args.serve_p99_warn,
                     shard_imbalance_warn=args.shard_imbalance_warn)
    print(f"{path}: {len(records)} records, schema OK")
    render(digest)
    return 1 if (args.strict and digest["warnings"]) else 0


if __name__ == "__main__":
    sys.exit(main())
