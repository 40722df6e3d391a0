#!/usr/bin/env python3
"""Time the port's sparse-rows step on one card, to compare two trees.

    python3 tools/sparse_step.py [--src DIR] [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
drives it at the main path's full width: the qwen2-0.5b table (151,936 x
896), ``SketchHParams()`` sketches, 16,384 zipf ids a step, backend
``tiled``.  It measures on the card:

  * 20 steps of ``make_sparse_embedding_step``: ms a step (CUDA events,
    median of steps 2..20), then 5 more under ``torch.profiler``: the
    device's busy time a step, the idle share against the unprofiled
    step, and the device launches a step, in all and by kernel name;
  * ``ops.adam_rows_tiled`` as the step calls it (ids and rows in, the
    update per input position out): CUDA-event ms a call, and the
    profiler's busy time and launches a call; and the launches of two of
    its parts, the dedup pre-pass and the addressing (three hash calls).

It prints one JSON line.  Run it on two trees in one command, in turns
(parent, change, change, parent), to compare them on one card.  The
helpers come from this checkout's ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT),
                        help="root of the tree whose src/repro_torch runs")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sparse_step: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import dedup as dd
    from repro_torch.kernels import ops
    from repro_torch.train.steps import (make_sparse_embedding_step,
                                         sparse_embedding_stores)
    dev = torch.device("cuda", 0)
    hp = SketchHParams(backend="tiled")
    init_fn, step_fn, opt = make_sparse_embedding_step(
        smoke.VOCAB, smoke.D_MODEL, lr=smoke.LR, hparams=hp, device=dev)
    table = init_fn(torch.Generator(device=dev).manual_seed(args.seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(args.seed + 1))
    state = opt.init()
    batches = smoke.zipf_ids(np.random.RandomState(args.seed), smoke.STEPS)
    table, state, _losses, ms = smoke.run_steps(step_fn, table, target,
                                                state, batches, dev)
    step_ms = statistics.median(ms[1:])
    more = smoke.zipf_ids(np.random.RandomState(args.seed + 30), 5)
    _out, _wall, kernels = smoke.kernel_profile(
        lambda: smoke.run_steps(step_fn, table, target, state, more, dev))
    busy = sum(k[0] for k in kernels) / len(more)

    m_store, v_store = sparse_embedding_stores(smoke.VOCAB, smoke.D_MODEL,
                                               hparams=hp)
    ids = torch.from_numpy(batches[-1]).to(dev)
    rows = table[ids.long()] - target[ids.long()]
    M, V = state["m"].clone(), state["v"].clone()

    def call():
        return ops.adam_rows_tiled(m_store.spec, v_store.spec, M, V, ids,
                                   rows, smoke.STEPS, lr=-1.0)
    call_ms = smoke.cuda_ms(call, reps=20, warmup=3)
    _out, _wall, prof = smoke.kernel_profile(
        lambda: [call() for _ in range(5)] + [torch.cuda.synchronize()])

    def launches(fn) -> float:
        fn()
        out = smoke.kernel_profile(
            lambda: [fn() for _ in range(5)] + [torch.cuda.synchronize()])
        return sum(p[1] for p in out[2]) / 5
    uids = dd.dedup_rows(ids, rows).unique_ids
    print(json.dumps({
        "src": str(Path(args.src).resolve()),
        "repro_torch": repro_torch.__file__,
        "card": smoke.nvidia_smi(),
        "step_ms": step_ms, "step_ms_all": ms, "step_busy_ms": busy,
        "idle_share": 1.0 - busy / step_ms,
        "launches_per_step": sum(k[1] for k in kernels) / len(more),
        "launches_per_step_by_name": {
            name: count / len(more) for _ms, count, name in kernels},
        "adam_rows_tiled_ms": call_ms,
        "adam_rows_tiled_busy_ms": sum(p[0] for p in prof) / 5,
        "adam_rows_tiled_launches": sum(p[1] for p in prof) / 5,
        "dedup_launches": launches(lambda: dd.dedup_rows(ids, rows)),
        "addressing_launches": launches(lambda: ops._adam_addressing(
            m_store.spec, v_store.spec, uids))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
