"""One run of one cell: set-up, the measured window, the traced steps
(``--trace 1``), the check against the plain reference, and the result
line.

Set-up runs from the process's start to the first timed step: the
kernels' build or load, the weights, the batch pool, and the program's
first three steps, which the reference follows afterwards.  The window
dispatches steps back to back from the pool with no host sync, for
``seconds`` of host time, and ends with one ``synchronize``; its rate is
all the work of its steps over all of its time.  The peak memory is
read over the window, the state already live.  The reference runs once
the window has closed, the peak has been read and the program's state
is freed, so it neither slows the window nor sets the peak.
"""
from __future__ import annotations

import sys
import time

import torch

from harness import check, manifest
from harness.trace import profile

GIB = float(1 << 30)
TRACED_STEPS = {"rows": 20, "tokens": 2}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec: manifest.CellSpec, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    cuda = torch.device(device).type == "cuda"
    cell = manifest.kind(spec.traffic).Cell(spec, seed, device)
    t_build = time.perf_counter()
    cell.build()
    _sync(device)
    t_steps = time.perf_counter()
    prog = cell.check_steps()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    _say(f"[bench] set-up: start to build {t_build - t_start:.3f} s, build "
         f"{t_steps - t_build:.3f} s, first steps and their readings "
         f"{t_start + setup_s - t_steps:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    _say(f"[bench] {spec.name} seed {seed}: set-up {setup_s:.3f} s, "
         f"first losses {prog['loss']}")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    i = first = len(prog["loss"])
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        losses.append(cell.step(i))
        i += 1
        if time.perf_counter() >= deadline:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = i - first
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finite = torch.isfinite(torch.stack(losses))
    n_bad = int((~finite).sum())
    last_loss = float(losses[-1])
    _say(f"[bench] window: {steps} steps in {window_s:.4f} s, last loss "
         f"{last_loss}, non-finite losses {n_bad}")

    rate = steps * cell.work_per_step / window_s
    e2e = {"setup_s": (setup_s, "s"),
           "sparse_rows_per_s": (rate, "rows/s"),
           "lm_tokens_per_s": (rate, "tokens/s"),
           "peak_mem_gib": (window_peak / GIB, "GiB")}
    metrics = {}
    breakdown = None
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if not trace:
        for m in spec.end_to_end:
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        tr = profile(cell.step, i, TRACED_STEPS[cell.unit],
                     lambda: _sync(device), cuda)
        traced = list(range(i + 1, i + 1 + tr.steps))
        ctx = {"cell": spec.name, "unit": cell.unit,
               "step_s": window_s / steps, "trace": tr if cuda else None,
               "counts": cell.counts(traced),
               "opt_state_bytes": cell.state_bytes()}
        for m in spec.per_layer:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if cuda:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            device_info["memory_peak_bytes"] = int(max(
                device_info["memory_peak_bytes"],
                torch.cuda.max_memory_allocated(device)))
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps":
                         tr.idle_gaps()}

    cell.free()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = cell.reference(steps=len(prog["loss"]))
    _say(f"[bench] reference: {time.perf_counter() - t_ref:.3f} s, losses "
         f"{ref['loss']}")
    look = {}
    numbers = check.gaps(prog, ref, look, cell.sketched)
    worst = sorted(look.items(), key=lambda kv: -kv[1])[:6]
    _say("[bench] largest gaps: " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in worst))
    correct, table = check.verdict(numbers, manifest.limits_of(spec))
    for k, row in table.items():
        _say(f"check {k} {row['value']!r} limit {row['limit']!r}")
    result = {"correct": bool(correct), "attempted": steps,
              "failed": n_bad, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    return result
