#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the count-sketch optimizer on one card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100, nvcc and
PyTorch built for CUDA.  It imports the port (``src/repro_torch``) and
nothing of the JAX package, and runs these phases, each printed on its
own line; any failure raises and the exit code is not 0:

  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (into ``build/kernels/``);
  2. each kernel against its plain PyTorch version on the card:
     B1 ``cs_adam_tiled`` bit-equal on a collision-free batch and within
     atol 2e-5 under heavy collisions, B2 ``cs_adam_fused`` bit-equal to
     ``ref.adam_fused_ref``, each with and without a first moment;
  3. the main path at full width: 20 steps of
     ``make_sparse_embedding_step`` on the tied embedding/softmax table of
     qwen2-0.5b (vocab 151,936 x d_model 896, from
     ``src/repro/configs/qwen2_0_5b.py:10-12``) with ``SketchHParams()``
     sketches, backend ``auto`` (= ``tiled``), 8 x 2,048 zipf ids a step;
     the loss on the first batch's ids must fall and B1 must launch.
     The per-batch loss (a fresh zipf sample each step) is printed, not
     required to fall: at this workload sketch noise on rare ids keeps it
     near its start.  Its witness: the same 20 batches from the same
     table through the plain ``xla`` backend must give the same per-batch
     losses and table.  Five more steps under ``torch.profiler`` give the
     device's busy time a step, set against the unprofiled step time;
  4. the serve entry ``make_online_adapt_step`` (β₁=0) for 10 steps, and
     3 steps of the main path on backend ``stream`` (B2);
  5. each kernel's time, its plain version's time and its byte bound at
     the phase-3 shapes.

It prints the kernels' JSON line and, last, ``{"ok": true, "device":
{...}}``.  With no card it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

VOCAB, D_MODEL = 151_936, 896      # src/repro/configs/qwen2_0_5b.py:10-12
BATCH, SEQ = 8, 2_048              # ids per step: 16,384
STEPS, SERVE_STEPS, STREAM_STEPS = 20, 10, 3
ZIPF_A = 1.1
LR = 3e-4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
COLLISION_ATOL = 2e-5              # reference envelope, tests/test_backends.py:207
WITNESS_TOL = dict(rtol=1e-4, atol=1e-5)   # phase 3b: tiled vs plain xla


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clone(xs):
    return [None if x is None else x.clone() for x in xs]


def errs(want, got) -> list:
    """Max absolute difference of each output (None where both are
    None)."""
    out = []
    for a, b in zip(want, got):
        if (a is None) != (b is None):
            raise AssertionError("one side returned None")
        out.append(None if a is None else
                   float((a - b).abs().max()) if a.numel() else 0.0)
    return out


def max_err(want, got) -> float:
    return max(e for e in errs(want, got) if e is not None)


def zipf_ids(rng: np.random.RandomState, steps: int) -> list:
    k = BATCH * SEQ
    return [((rng.zipf(ZIPF_A, k) - 1) % VOCAB).astype(np.int32)
            for _ in range(steps)]


def kernel_counts():
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import cs_adam_tiled
    return {"cs_adam_tiled": cs_adam_tiled, "cs_adam_fused": cs_adam_fused}


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counts().items()}


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev, seed: int) -> None:
    import torch
    from repro_torch.core import sketch as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import (cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)

    def state(depth, width, d, track_m):
        M = torch.randn((depth, width, d), generator=gen, device=dev) \
            if track_m else None
        V = torch.randn((depth, width, d), generator=gen, device=dev).abs()
        return M, V

    for track_m in (True, False):
        b1 = 0.9 if track_m else 0.0
        tag = f"b1={b1}"
        # B1, collision-free: identity hashing, unique ids
        spec = cs.for_param((4_096, D_MODEL), identity=True)
        M, V = state(3, spec.width, D_MODEL, track_m)
        ids = torch.randperm(spec.width, generator=gen, device=dev)[:2_048]
        fam = spec.family
        b, s = fam.bucket(ids.to(torch.int32)), fam.sign(ids)
        g = torch.randn((2_048, D_MODEL), generator=gen, device=dev)
        args = (M, V, b if track_m else None, s if track_m else None, b, g)
        want = cs_adam_tiled_plain(*clone(args), b1=b1, n_valid=2_040, **kw)
        got = cs_adam_tiled(*clone(args), b1=b1, n_valid=2_040, **kw)
        torch.cuda.synchronize()
        bit = all(a is None or torch.equal(a, c) for a, c in zip(want, got))
        log(f"phase 2: B1 cs_adam_tiled collision-free k=2048 d={D_MODEL} "
            f"{tag}: bit_equal={bit} max_abs_err (M, V, upd) "
            f"{errs(want, got)}")
        if not bit:
            raise AssertionError("B1 is not bit-equal on a collision-free "
                                 "batch")
        # B1, heavy collisions: width 16, k 32
        M, V = state(3, 16, D_MODEL, track_m)
        bm = torch.randint(0, 16, (3, 32), generator=gen, device=dev,
                           dtype=torch.int32)
        bv = torch.randint(0, 16, (3, 32), generator=gen, device=dev,
                           dtype=torch.int32)
        sm = torch.randint(0, 2, (3, 32), generator=gen, device=dev
                           ).float() * 2 - 1
        g = torch.randn((32, D_MODEL), generator=gen, device=dev)
        args = (M, V, bm if track_m else None, sm if track_m else None, bv, g)
        want = cs_adam_tiled_plain(*clone(args), b1=b1, n_valid=29, **kw)
        got = cs_adam_tiled(*clone(args), b1=b1, n_valid=29, **kw)
        err = max_err(want, got)
        log(f"phase 2: B1 cs_adam_tiled collisions width=16 k=32 {tag}: "
            f"max_abs_err (M, V, upd) {errs(want, got)} (atol "
            f"{COLLISION_ATOL})")
        if not err <= COLLISION_ATOL:
            raise AssertionError(f"B1 under collisions: {err}")
        # B2 against the per-item plain version, k=512, real hashing
        spec_m = cs.for_param((VOCAB, D_MODEL), signed=True, seed=seed + 1)
        spec_v = cs.for_param((VOCAB, D_MODEL), signed=False, seed=seed + 2)
        M, V = state(3, spec_v.width, D_MODEL, track_m)
        ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed), 1)[0]
                               [:512]).to(dev)
        g = torch.randn((512, D_MODEL), generator=gen, device=dev)
        args = (M, V, spec_m.family.bucket(ids) if track_m else None,
                spec_m.family.sign(ids) if track_m else None,
                spec_v.family.bucket(ids), g)
        want = ref.adam_fused_ref(*clone(args), b1=b1, **kw)
        got = cs_adam_fused(*clone(args), b1=b1, **kw)
        torch.cuda.synchronize()
        bit = all(a is None or torch.equal(a, c) for a, c in zip(want, got))
        log(f"phase 2: B2 cs_adam_fused k=512 d={D_MODEL} "
            f"({len(set(ids.tolist()))} unique ids) {tag}: bit_equal={bit} "
            f"max_abs_err (M, V, upd) {errs(want, got)}")
        if not bit:
            raise AssertionError("B2 is not bit-equal to adam_fused_ref")


# ---------------------------------------------------------------- phase 3
def run_steps(step_fn, table, target, state, batches, dev):
    """Drive ``step_fn`` over ``batches``; returns (table, state, losses,
    per-step ms)."""
    import torch
    losses, events = [], []
    for ids_np in batches:
        ids = torch.from_numpy(ids_np).to(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        idx = ids.long()
        rows = table[idx] - target[idx]
        losses.append(torch.mean(rows * rows))
        table, state = step_fn(table, state, ids, rows)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (table, state, [float(x) for x in losses],
            [s.elapsed_time(e) for s, e in events])


def phase_main(dev, seed: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    hp = SketchHParams()
    backend = kernels.resolve_backend(hp.backend, dev)
    if backend != "tiled":
        raise AssertionError(f"auto resolved to {backend!r} on the card")
    init_fn, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, hparams=hp, device=dev)
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    table = table0.clone()
    state = opt.init()
    log(f"phase 3: table {tuple(table.shape)} f32 {table.numel() * 4} B; "
        f"sketches m {tuple(state['m'].shape)} v {tuple(state['v'].shape)} "
        f"{state['v'].numel() * 4} B each; backend auto -> {backend}")
    batches = zipf_ids(np.random.RandomState(seed), STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()
    fresh = torch.from_numpy(zipf_ids(np.random.RandomState(seed + 99), 1)[0]
                             ).to(dev).long()

    def loss_on(idx) -> float:
        rows = table[idx] - target[idx]
        return float(torch.mean(rows * rows))

    held_before, fresh_before = loss_on(held), loss_on(fresh)
    torch.cuda.synchronize()
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table, target, state,
                                         batches, dev)
    counts = read_counts()
    held_after, fresh_after = loss_on(held), loss_on(fresh)
    uniq = [int(np.unique(b).size) for b in batches]
    log(f"phase 3: {STEPS} steps x {BATCH * SEQ} ids; unique ids per step "
        f"{uniq}")
    log(f"phase 3: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (first step {ms[0]}); all {ms}")
    log(f"phase 3: loss on the first batch's ids before {held_before} "
        f"after {held_after}; on a fresh zipf batch before {fresh_before} "
        f"after {fresh_after}")
    log(f"phase 3: per-step batch loss (not required to fall) {losses}")
    log(f"phase 3: kernel launches {counts}")
    if counts["cs_adam_tiled"] <= 0:
        raise AssertionError("the main path did not launch B1")
    if not held_after < held_before:
        raise AssertionError("the loss did not fall")
    if not (torch.isfinite(table).all() and torch.isfinite(state["m"]).all()
            and torch.isfinite(state["v"]).all()):
        raise AssertionError("non-finite table or sketch")
    phase_witness(dev, table0, target, batches, table, losses)
    del table0
    table, state = phase_profile(dev, step_fn, table, target, state, seed,
                                 statistics.median(ms[1:]))
    return table, target, state, batches[-1], counts


def phase_witness(dev, table0, target, batches, tiled_table, tiled_losses):
    """The main path's batches from its initial table through the plain
    ``xla`` backend: the per-batch losses and the table must agree with
    the ``tiled`` run (B1's atomics reorder colliding adds)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    _init, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="xla"))
    table, _state, losses, ms = run_steps(step_fn, table0, target,
                                          opt.init(), batches, dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, losses))
    err = float((table - tiled_table).abs().max())
    log(f"phase 3b: plain xla, same {len(batches)} batches at full width: "
        f"ms/step median {statistics.median(ms[1:])}; per-step batch loss "
        f"{losses}")
    log(f"phase 3b: tiled vs plain xla: per-batch loss max rel diff {rel}, "
        f"table max_abs_err {err} (rtol {WITNESS_TOL['rtol']}, atol "
        f"{WITNESS_TOL['atol']})")
    torch.testing.assert_close(torch.tensor(tiled_losses),
                               torch.tensor(losses), rtol=WITNESS_TOL["rtol"],
                               atol=0.0)
    torch.testing.assert_close(tiled_table, table, **WITNESS_TOL)


def phase_profile(dev, step_fn, table, target, state, seed: int,
                  step_ms: float):
    """Five more main-path steps under ``torch.profiler``: the device's
    busy time a step and the kernels that take it.  The idle share is
    taken against ``step_ms``, the unprofiled step time, since the
    profiler slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batches = zipf_ids(np.random.RandomState(seed + 30), 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        table, state, _, _ = run_steps(step_fn, table, target, state,
                                       batches, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms <= 0.0:
        log("phase 3c: device busy time not measured (the profiler saw no "
            "CUDA kernels)")
        return table, state
    log(f"phase 3c: 5 steps under torch.profiler: wall {wall_ms} ms, "
        f"device busy {busy_ms} ms ({busy_ms / 5} ms a step); idle share "
        f"{1.0 - busy_ms / 5 / step_ms} against the unprofiled step of "
        f"{step_ms} ms ({1.0 - busy_ms / wall_ms} with the profiler on)")
    for ms, count, name in kernels[:10]:
        log(f"phase 3c:   {ms} ms  x{count}  {name[:90]}")
    return table, state


# ---------------------------------------------------------------- phase 4
def phase_serve_and_stream(dev, table, target, seed: int):
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.serve.steps import make_online_adapt_step
    from repro_torch.train.steps import make_sparse_embedding_step
    init_state, adapt = make_online_adapt_step(VOCAB, D_MODEL, lr=LR,
                                               device=dev)
    state = init_state()
    if state["m"] is not None:
        raise AssertionError("the serve step keeps a first moment")
    batches = zipf_ids(np.random.RandomState(seed + 10), SERVE_STEPS)
    reset_counts()
    table, state, losses, ms = run_steps(adapt, table, target, state,
                                         batches, dev)
    serve_counts = read_counts()
    log(f"phase 4: serve make_online_adapt_step (b1=0) {SERVE_STEPS} steps: "
        f"ms/step median {statistics.median(ms[1:])}; loss first "
        f"{losses[0]} last {losses[-1]}; launches {serve_counts}")
    if serve_counts["cs_adam_tiled"] != SERVE_STEPS:
        raise AssertionError("the serve path did not launch B1 every step")
    _init, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="stream"))
    # stream applies every occurrence of an id (no dedup, paper Alg. 4),
    # so a zipf head moves far: run it on a copy of the table
    batches = zipf_ids(np.random.RandomState(seed + 20), STREAM_STEPS)
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table.clone(), target,
                                         opt.init(), batches, dev)
    stream_counts = read_counts()
    log(f"phase 4: backend stream {STREAM_STEPS} steps: ms/step {ms}; loss "
        f"{losses}; launches {stream_counts}")
    if stream_counts["cs_adam_fused"] != STREAM_STEPS:
        raise AssertionError("the stream path did not launch B2 every step")
    if not torch.isfinite(table).all():
        raise AssertionError("non-finite table after phase 4")
    return stream_counts


# ---------------------------------------------------------------- phase 5
def unique_rows(buckets, n_valid: int, width: int) -> int:
    """Distinct (hash row, bucket) pairs among the first n_valid items:
    the sketch rows a step must read and write."""
    import torch
    b = buckets[:, :n_valid].long()
    rows = torch.arange(b.shape[0], device=b.device)[:, None]
    return int((b + width * rows).unique().numel())


def phase_times(dev, table, target, state, ids_np, seed: int) -> list:
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import dedup as dd, ops, ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import (cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    from repro_torch.train.steps import sparse_embedding_stores
    m_store, v_store = sparse_embedding_stores(VOCAB, D_MODEL,
                                               hparams=SketchHParams())
    spec_m, spec_v = m_store.spec, v_store.spec
    ids = torch.from_numpy(ids_np).to(dev)
    rows = table[ids.long()] - target[ids.long()]
    eta, bc1, bc2 = ops._adam_hypers(STEPS, -1.0, 0.9, 0.999)
    kw = dict(lr=eta, b1=0.9, b2=0.999, eps=1e-8, bc1=bc1, bc2=bc2)
    out = []
    # B1 at the inputs the tiled backend gives it
    batch = dd.dedup_rows(ids, rows)
    bm, sm, bv = ops._adam_addressing(spec_m, spec_v, batch.unique_ids)
    k_u = int(batch.n_unique)
    args = (state["m"], state["v"], bm, sm, bv, batch.rows)
    want = cs_adam_tiled_plain(*clone(args), n_valid=batch.n_unique, **kw)
    got = cs_adam_tiled(*clone(args), n_valid=batch.n_unique, **kw)
    err = max_err(want, got)
    upd_bit = torch.equal(want[2], got[2])
    if not (upd_bit and err <= COLLISION_ATOL):
        raise AssertionError(f"B1 at main-path shapes: upd bit-equal "
                             f"{upd_bit}, max_abs_err {err}")
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_tiled(*scratch, n_valid=batch.n_unique,
                                       **kw), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: cs_adam_tiled_plain(
        *scratch, n_valid=batch.n_unique, **kw), reps=5)
    depth = spec_v.depth
    nbytes = (4 * D_MODEL * 2 * k_u
              + 4 * D_MODEL * 2 * (unique_rows(bm, k_u, spec_m.width)
                                   + unique_rows(bv, k_u, spec_v.width))
              + 4 * 3 * depth * k_u + 4)
    out.append(dict(name="cs_adam_tiled", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam_tiled.cu",
                    replaces="src/repro/kernels/cs_adam_tiled.py:153",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=int(ids.numel()),
                    k_unique=k_u, bytes=nbytes))
    log(f"phase 5: B1 k_u={k_u} (of {ids.numel()}): {ms} ms, plain "
        f"{plain_ms} ms, bound {out[-1]['bound_ms']} ms ({nbytes} B at "
        f"3.35 TB/s); vs plain upd bit-equal, max_abs_err {err}")
    # B2 at the inputs the stream backend gives it: the raw ids, in order
    bm, sm, bv = ops._adam_addressing(spec_m, spec_v, ids)
    args = (state["m"], state["v"], bm, sm, bv, rows.contiguous())
    got = cs_adam_fused(*clone(args), **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.adam_fused_ref(*clone(args), **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(want, got)
    if err != 0.0:
        raise AssertionError(f"B2 at main-path shapes: max_abs_err {err}")
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_fused(*scratch, **kw), reps=5)
    k = int(ids.numel())
    nbytes = (4 * D_MODEL * 2 * k
              + 4 * D_MODEL * 2 * (unique_rows(bm, k, spec_m.width)
                                   + unique_rows(bv, k, spec_v.width))
              + 4 * 3 * depth * k)
    out.append(dict(name="cs_adam_fused", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam.cu",
                    replaces="src/repro/kernels/cs_adam.py:110",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k,
                    k_unique=int(np.unique(ids_np).size), bytes=nbytes))
    log(f"phase 5: B2 k={k}: {ms} ms, plain {plain_ms} ms (one run), bound "
        f"{out[-1]['bound_ms']} ms ({nbytes} B at 3.35 TB/s); vs plain "
        f"bit-equal")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    lib_path, secs, build_log = build.build()
    build.library()
    log(f"phase 1: built {lib_path.relative_to(ROOT)} in {secs:.1f} s"
        + ("" if secs else " (already built)"))
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"phase 1:   {line.strip()}")
    phase_kernels(dev, args.seed)
    table, target, state, last_ids, main_counts = phase_main(dev, args.seed)
    stream_counts = phase_serve_and_stream(dev, table, target, args.seed)
    kernels = phase_times(dev, table, target, state, last_ids, args.seed)
    kernels[0]["launches"] = main_counts["cs_adam_tiled"]
    kernels[1]["launches"] = stream_counts["cs_adam_fused"]
    log(f"peak device memory {torch.cuda.max_memory_allocated()} B")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
