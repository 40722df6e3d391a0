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
     B1 ``cs_adam_tiled`` bit-equal on a collision-free batch, and under
     heavy collisions M and V bit-equal to the plain version on a CPU copy
     (upd within rtol 1e-6 of it: torch's CPU sqrt), within atol 2e-5 of
     it on the card and the same bits on a second run; B1 as the
     ``tiled`` path calls it (``ops.adam_rows_tiled``) on a full-width
     zipf batch, the same against a CPU copy; B4 at full width bit-equal;
     B2 ``cs_adam_fused`` bit-equal to
     ``ref.adam_fused_ref``, each with and without a first moment, and B2
     again where a bucket recurs 1, L-1, L and L+1 items back (L its
     window) and with k below one tile; the bucket CSR kernel
     (``cs_update.bucket_csr``/``bucket_prev``) integer-equal to its plain
     form (stable ``torch.sort``), prev included; B5 bit-equal to a CPU
     copy on one run of all items, with d not a multiple of 4, and on
     runs long enough for its long-run blocks;
     B3 ``cs_ema_tiled`` (signed and unsigned, the three ``ema_delta``
     forms, with and without a mask) and B5 ``cs_update`` bit-equal on a
     collision-free batch, within atol 2e-5 under heavy collisions and
     then bit-equal to the plain version on a CPU copy; B4 ``cs_query``
     bit-equal;
  3. the main path at full width: 20 steps of
     ``make_sparse_embedding_step`` on the tied embedding/softmax table of
     qwen2-0.5b (vocab 151,936 x d_model 896, from
     ``src/repro/configs/qwen2_0_5b.py:10-12``) with ``SketchHParams()``
     sketches, backend ``auto`` (= ``tiled``), 8 x 2,048 zipf ids a step;
     the loss on the first batch's ids must fall and B1, its CSR and the
     dedup sum (B5) must launch once a step.
     The per-batch loss (a fresh zipf sample each step) is printed, not
     required to fall: at this workload sketch noise on rare ids keeps it
     near its start.  Its witness: the same 20 batches from the same
     table through the plain ``xla`` backend must give the same per-batch
     losses and table (rtol 1e-4; whether they are equal to the bit is
     printed).  3f: the 20 steps again from the same start must give the
     same table and sketches to the bit, and one more step runs under
     ``torch.cuda.set_sync_debug_mode("error")``.  Five more steps under
     ``torch.profiler`` give the device's busy time a step, set against
     the unprofiled step time, and the launches a step by kernel name.
     The same 20 batches as dense gradients (``zeros.index_add_(0, ids,
     rows)``) through ``adam_from_stores`` with the same stores on
     ``auto`` (B3) must give phase 3's table (3d), and through dense Adam
     (``optimizers.adam``) show what sketching costs the loss (3e);
  4. the serve entry ``make_online_adapt_step`` (β₁=0) for 10 steps, 3
     steps of the main path on backend ``stream`` (B2), and the batch
     sketch ops ``ops.sketch_update``/``sketch_query`` (B5, B4) on one
     main-path batch;
  5. each kernel's time, its plain version's time and its byte bound at
     the shapes its path gives it: B1 alone and ``ops.adam_rows_tiled`` as
     the step calls it (time, busy time, launches); B5 as users call it
     (its CSR built in
     the call) beside the CSR alone, the scatter alone, one ``index_add_``
     and the plain version; B2 with its prev pass; the CSR kernel beside
     one stable ``torch.sort``; B3 (f32 and bf16 cells) with its column
     slices: their width, count and scratch bytes, one slice's read and
     scatter, the kernels' busy time within a call, and a call at other
     slice widths;
  6. the dense path at full width: the softmax layer of qwen2-0.5b
     (``tok_embed/table`` 151,936 x 896 and ``final_norm/scale``),
     cross-entropy of ``rmsnorm(h)*scale @ table^T`` on 1,024 zipf(1.1)
     targets a step with ``h = teacher[y] + noise``, full softmax so
     every row has a gradient, ``countsketch_adam(SketchPolicy(),
     backend auto)`` at lr 3e-5: 20 steps; the loss on batch 0's tokens
     must fall, B3 must launch twice a step, and the same batches
     through plain ``xla`` must give the same losses and table; five
     steps under the profiler.  At the main path's lr 3e-4 the sketched
     first moment makes some rows' directions reach the thousands and
     the loss rises; 6d prints that run beside the dense-first-moment
     (CS-V) and all-dense Adam runs on the same batches;
  7. phase 6's task with bf16 sketch cells (``SketchHParams(dtype=
     "bfloat16")``, 55,050,240 B a moment against 110,100,480 in f32):
     20 steps on ``auto``, B3's bf16 kernel must launch twice a step (its
     launches are counted apart, ``cs_ema_tiled_bf16``), the loss on
     batch 0's tokens must fall, and the plain ``xla`` witness must give
     the per-step losses within rtol 1e-4; printed beside phase 6's f32
     run.  7b: int8 cells on the same layer, 5 steps through the plain
     route (no B3), the loss must fall and the table stay finite.  7c:
     bf16 cells on phase 3's sparse-rows batches, backend ``tiled``: no
     B1 launch (low-precision cells run ``xla``, as in the reference,
     whose sums go through B5), the held loss must fall, and the steps
     run twice from the same start must give the same bits.  7d: the bf16 dense path with a Count-Min
     cleaned every 5 steps, 10 steps sync against ``AsyncCleaner``: the
     table and sketches must be equal to the bit.
  8. the MACH extreme-classification step (``train/extreme.py::
     make_extreme_step``) at the reference's full scale,
     ``benchmarks/extreme_scale.py:191-194``: 8,000,000 classes hashed
     into a 2,097,152 x 64 class head, a 65,536 x 64 feature table, 16
     zipf(1.05) features an example, 1,024 shared negatives, batch 1,024,
     lr 1e-2, ``SketchHParams(compression=100.0)``, backend ``auto``
     (``tiled``).  8a: ``cs_rmsprop`` (B1 without M) on both replicas, 20
     steps each, each replica's batches through its class map; the mean
     of the last w losses must be below the first w's (w = max(1,
     min(10, steps // 3)), the reference launcher's check); B1, its CSR
     and the dedup sum must launch once a table a step; five more steps
     under the profiler.  8b: replica 0's batches through ``xla`` within
     rtol 1e-4, atol 1e-5 (printed: equal to the bit).  8c: 8a's replica
     0 again: tables, V and losses to the bit; one step under
     ``set_sync_debug_mode("error")``.  8d: ``cs_adam`` (B1 with M) and
     ``dense_adam``, the same loss check, each arm's ``state_bytes``.
     8e: the peak device memory of a step of ``dense_adam`` and
     ``cs_rmsprop`` at batch 1,024 and 8,192.  8f: C1's last sites
     (the ordered table add, the dense path's plain routes, a 1-D
     ``DenseStore``) give the same bits twice and a CPU copy's; B1 at both
     tables' shapes, with and without M, held to its plain version and a
     CPU copy, and timed beside its bound (printed as phase 5 rows).

Phase 2 also holds B3's bf16 branch to its plain version (bit-equal on a
CPU copy; within one bf16 ulp plus the f32 collision envelope of the
plain version on the card, whose index_add_ sums in atomic order), and
phase 5 times it at the dense path's shapes.  Each phase prints its wall
time.  It prints the kernels' JSON line, the
card's name and power limit and, last, ``{"ok": true, "device":
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
TOKENS = 1_024                     # phase 6: targets a step
DENSE_LR = 3e-5                    # phase 6: at LR the loss rises (6d)
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
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_bf16)
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import bucket_csr, cs_update
    return {"cs_adam_tiled": cs_adam_tiled, "cs_adam_fused": cs_adam_fused,
            "cs_ema_tiled": cs_ema_tiled,
            "cs_ema_tiled_bf16": cs_ema_tiled_bf16, "cs_query": cs_query,
            "cs_update": cs_update, "bucket_csr": bucket_csr}


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
        again = cs_adam_tiled(*clone(args), b1=b1, n_valid=29, **kw)
        host = cs_adam_tiled_plain(*on_cpu(args), b1=b1, n_valid=29, **kw)
        err = max_err(want, got)
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        log(f"phase 2: B1 cs_adam_tiled collisions width=16 k=32 {tag}: "
            f"{b1_vs_cpu(host, got)}; max_abs_err (M, V, upd) vs the plain "
            f"version on the card {errs(want, got)} (atol {COLLISION_ATOL}); "
            f"a second run equal to the bit {same}")
        if not (err <= COLLISION_ATOL and same
                and torch.equal(want[2], got[2])):
            raise AssertionError(f"B1 under collisions: {err}, second run "
                                 f"equal {same}")
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


def b1_vs_cpu(host, got) -> str:
    """Hold B1's (M, V, upd) to a CPU copy's: M and V to the bit; upd to
    the bit or within rtol 1e-6, for torch's CPU f32 sqrt, which is not
    always correctly rounded (the values apart are counted and printed).
    Returns the line's text."""
    import torch
    for name, a, c in zip(("M", "V"), host[:2], got[:2]):
        if a is not None and not torch.equal(a, c.cpu()):
            raise AssertionError(f"B1's {name} is not bit-equal to a CPU copy "
                                 f"(max_abs_err {max_err([a], [c.cpu()])})")
    upd = got[2].cpu()
    differ = int((upd != host[2]).sum())
    rel = float(((upd - host[2]).abs() / host[2].abs()).nan_to_num().max())
    torch.testing.assert_close(upd, host[2], rtol=1e-6, atol=0.0)
    return (f"M and V bit-equal to a CPU copy; upd {differ} of "
            f"{upd.numel()} values apart from it, max rel diff {rel} "
            f"(torch's CPU sqrt)")


def phase_full_width_b1_b4(dev, seed: int) -> None:
    """B1 as the ``tiled`` path calls it (``ops.adam_rows_tiled``: dedup,
    addressing, B1 with its per-position output) on a full-width zipf
    batch into ``SketchHParams()`` sketches with random moments, against
    the same call on a CPU copy; two runs on the card equal to the bit.
    B4 on the same batch into the same sketch, bit-equal to
    ``ref.cs_query_ref``."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cs_query import cs_query
    hp = SketchHParams()
    spec_m = hp.spec("sparse_embedding", (VOCAB, D_MODEL), signed=True)
    spec_v = hp.spec("sparse_embedding", (VOCAB, D_MODEL), signed=False)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    M = torch.randn(spec_m.shape, generator=gen, device=dev) * 1e-3
    V = torch.rand(spec_v.shape, generator=gen, device=dev) * 1e-6
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed + 7), 1)[0]
                           ).to(dev)
    g = torch.randn((ids.numel(), D_MODEL), generator=gen, device=dev) * 1e-3
    kw = dict(lr=-1.0, b1=0.9, b2=0.999, eps=1e-8)
    got = ops.adam_rows_tiled(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                              STEPS, **kw)
    again = ops.adam_rows_tiled(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                                STEPS, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    host = ops.adam_rows_tiled(spec_m, spec_v, *on_cpu([M, V, ids, g]),
                               STEPS, **kw)
    line = b1_vs_cpu(host, got)
    log(f"phase 2: B1 as the tiled path calls it, {ids.numel()} zipf ids "
        f"({len(set(ids.tolist()))} unique) into {spec_m.shape} sketches: "
        f"{line}; a second run equal to the bit {same}")
    if not same:
        raise AssertionError("two runs of the tiled path differ")
    del got, again, host
    b, s = spec_m.family.bucket(ids), spec_m.family.sign(ids)
    for signed in (True, False):
        out = cs_query(M if signed else V, b, s if signed else None)
        if not torch.equal(out, ref.cs_query_ref(M if signed else V, b,
                                                  s if signed else None)):
            raise AssertionError(f"B4 at full width is not bit-equal, "
                                 f"signed={signed}")
    log(f"phase 2: B4 cs_query k={ids.numel()} into {spec_m.shape}, signed "
        f"and unsigned: bit-equal to ref.cs_query_ref")


def hazard_buckets(k: int, dists, dev):
    """Row r puts item i in bucket i % dists[r]: each item's last earlier
    item in its bucket is exactly dists[r] places back."""
    import torch
    i = torch.arange(k, device=dev)
    return torch.stack([i % dd for dd in dists]).to(torch.int32).contiguous()


def phase_csr_and_hazards(dev, seed: int) -> None:
    """The CSR kernel integer-equal to the plain ``bucket_csr`` (order,
    starts and prev); B5 on one run of all k items (width 1) and with d
    not a multiple of 4, bit-equal to a CPU copy; B2 bit-equal to its
    plain version where a bucket recurs 1, L-1, L and L+1 items back (L
    its window), and with k below one tile."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import cs_adam, ops, ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_update import (bucket_csr, bucket_csr_plain,
                                               bucket_prev, cs_update)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    spec = SketchHParams().spec("sparse_embedding", (VOCAB, D_MODEL),
                                signed=True)
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed), 1)[0]
                           ).to(dev)
    cases = {
        "zipf ids at full width": (spec.family.bucket(ids), spec.width),
        "dense rows (151,936)": (ops._cached_addressing(spec, VOCAB, dev)[0],
                                 spec.width),
        "width 1": (torch.zeros((3, 4_000), dtype=torch.int32, device=dev),
                    1),
        "one bucket": (torch.full((3, 4_000), 5, dtype=torch.int32,
                                  device=dev), 64),
        "last buckets": (torch.randint(spec.width - 2, spec.width, (3, 4_000),
                                       generator=gen, device=dev,
                                       dtype=torch.int32), spec.width),
        "k=0": (torch.zeros((3, 0), dtype=torch.int32, device=dev),
                spec.width),
    }
    for tag, (b, width) in cases.items():
        got = (*bucket_csr(b, width), bucket_prev(b, width))
        want = bucket_csr_plain(b, width)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(want, got)):
            raise AssertionError(f"bucket_csr kernel differs from the plain "
                                 f"form, {tag}")
    for width, d in ((1, D_MODEL), (spec.width, 893), (2, 893)):
        S = torch.randn((3, width, d), generator=gen, device=dev)
        b = spec.family.bucket(ids[:4_000]) % width
        s = spec.family.sign(ids[:4_000])
        x = torch.randn((4_000, d), generator=gen, device=dev)
        got = cs_update(S.clone(), b, s, x)
        if not torch.equal(ref.cs_update_ref(*on_cpu([S, b, s, x])),
                           got.cpu()):
            raise AssertionError(f"B5 width={width} d={d} is not bit-equal "
                                 f"to its plain version on a CPU copy")
    kw = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)
    window = cs_adam.WINDOW
    dists = [1, window - 1, window, window + 1]
    for k in (5, 300):
        for track_m in (True, False):
            depth = len(dists)
            M = torch.randn((depth, 64, D_MODEL), generator=gen,
                            device=dev) if track_m else None
            V = torch.randn((depth, 64, D_MODEL), generator=gen,
                            device=dev).abs()
            bm = hazard_buckets(k, dists, dev)
            sm = torch.randint(0, 2, (depth, k), generator=gen,
                               device=dev).float() * 2 - 1
            bv = hazard_buckets(k, dists[::-1], dev)
            g = torch.randn((k, D_MODEL), generator=gen, device=dev)
            args = (M, V, bm if track_m else None, sm if track_m else None,
                    bv, g)
            b1 = 0.9 if track_m else 0.0
            want = ref.adam_fused_ref(*clone(args), b1=b1, **kw)
            got = cs_adam_fused(*clone(args), b1=b1, **kw)
            torch.cuda.synchronize()
            if not all(a is None or torch.equal(a, c)
                       for a, c in zip(want, got)):
                raise AssertionError(
                    f"B2 k={k} b1={b1} distances {dists}: not bit-equal, "
                    f"max_abs_err {errs(want, got)}")
    log(f"phase 2: bucket_csr kernel integer-equal to the plain form "
        f"(order, starts, prev) on {len(cases)} cases ({', '.join(cases)}); "
        f"B5 bit-equal to a CPU copy at width 1 (one run of 4,000 items), "
        f"at d=893 (scalar path) and at width 2, d=893 (long runs, scalar); "
        f"B2 bit-equal to adam_fused_ref where a bucket recurs "
        f"{dists} items back (window {window}), k 5 and 300, b1 0.9 and 0")


EMA_FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
             "momentum": (0.9, 1.0)}


def on_cpu(xs):
    return [None if x is None else x.cpu() for x in xs]


def phase_sketch_kernels(dev, seed: int) -> None:
    """B3, B4 and B5 against their plain versions at d_model width."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import cs_update
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    k = 2_048

    def case(signed, width, collision_free):
        S = torch.randn((3, width, D_MODEL), generator=gen, device=dev)
        if collision_free:
            b = torch.randperm(width, generator=gen, device=dev)[:k].to(
                torch.int32)[None].expand(3, k).contiguous()
        else:
            b = torch.randint(0, width, (3, k), generator=gen, device=dev,
                              dtype=torch.int32)
        s = (torch.randint(0, 2, (3, k), generator=gen, device=dev).float()
             * 2 - 1) if signed else None
        x = torch.randn((k, D_MODEL), generator=gen, device=dev)
        mask = (torch.rand((k, 1), generator=gen, device=dev) > 0.3).float()
        return (S if signed else S.abs()), b, s, x, mask

    worst = 0.0
    for signed in (True, False):
        for form, (beta, scale) in EMA_FORMS.items():
            for masked in (False, True):
                for width, free in ((4_096, True), (64, False)):
                    S, b, s, x, mask = case(signed, width, free)
                    m = mask if masked else None
                    want = cs_ema_tiled_plain(S.clone(), b, s, x, m,
                                              beta=beta, scale=scale)
                    got = cs_ema_tiled(S.clone(), b, s, x, m, beta=beta,
                                       scale=scale)
                    torch.cuda.synchronize()
                    tag = (f"signed={signed} {form} mask={masked} "
                           f"width={width}")
                    if free:
                        if not all(torch.equal(a, c)
                                   for a, c in zip(want, got)):
                            raise AssertionError(f"B3 not bit-equal on a "
                                                 f"collision-free batch, {tag}")
                        continue
                    err = max_err(want, got)
                    worst = max(worst, err)
                    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, m]),
                                              beta=beta, scale=scale)
                    if not (err <= COLLISION_ATOL and all(
                            torch.equal(a, c.cpu())
                            for a, c in zip(host, got))):
                        raise AssertionError(f"B3 under collisions, {tag}: "
                                             f"max_abs_err {err}")
    log(f"phase 2: B3 cs_ema_tiled k={k} d={D_MODEL}, signed and unsigned x "
        f"3 ema_delta forms x mask on/off: bit-equal on collision-free "
        f"batches (width 4096); width 64 (32 rows a bucket): max_abs_err "
        f"(S, est) {worst} vs the plain version on the card (atol "
        f"{COLLISION_ATOL}), bit-equal to it on a CPU copy")
    for signed in (True, False):
        S, b, s, _, _ = case(signed, 512, False)
        if not torch.equal(cs_query(S, b, s), ref.cs_query_ref(S, b, s)):
            raise AssertionError(f"B4 not bit-equal, signed={signed}")
        for width, free in ((4_096, True), (64, False)):
            S, b, s, x, _ = case(signed, width, free)
            want = ref.cs_update_ref(S.clone(), b, s, x)
            got = cs_update(S.clone(), b, s, x)
            torch.cuda.synchronize()
            err = float((want - got).abs().max())
            host = ref.cs_update_ref(*on_cpu([S, b, s, x]))
            ok = err == 0.0 if free else (err <= COLLISION_ATOL and
                                          torch.equal(host, got.cpu()))
            if not ok:
                raise AssertionError(f"B5 signed={signed} width={width}: "
                                     f"max_abs_err {err}")
    log(f"phase 2: B4 cs_query k={k} width 512 bit-equal; B5 cs_update "
        f"bit-equal collision-free, within atol {COLLISION_ATOL} at width 64 "
        f"and bit-equal to the plain version on a CPU copy (signed and "
        f"unsigned)")


def bf16_within(got, want, atol: float) -> bool:
    """Every bf16 cell within one bf16 ulp of ``want`` plus ``atol``."""
    import torch
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    return bool(((g - w).abs() <= ulp + atol).all())


def phase_bf16_kernel(dev, seed: int) -> None:
    """B3's bf16 branch against its plain version: signed and unsigned,
    collision-free (identity buckets) and colliding (width 16).  Bit-equal
    to the plain version on a CPU copy (bf16 cells and ``est``); on the
    card ``est`` is bit-equal and the cells within one bf16 ulp plus the
    f32 collision envelope (the plain version's index_add_ sums each
    cell's increments in atomic order, and a rounding may then flip)."""
    import torch
    from repro_torch.core import quantize as qz
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    k, sr = 2_048, qz.step_seed(seed, 7)
    report = []
    for signed in (True, False):
        for width, free in ((4_096, True), (16, False)):
            S = torch.randn((3, width, D_MODEL), generator=gen, device=dev)
            S = (S if signed else S.abs()).to(torch.bfloat16)
            if free:
                b = torch.randperm(width, generator=gen, device=dev)[:k].to(
                    torch.int32)[None].expand(3, k).contiguous()
            else:
                b = torch.randint(0, width, (3, k), generator=gen,
                                  device=dev, dtype=torch.int32)
            s = (torch.randint(0, 2, (3, k), generator=gen, device=dev
                               ).float() * 2 - 1) if signed else None
            x = torch.randn((k, D_MODEL), generator=gen, device=dev)
            mask = (torch.rand((k, 1), generator=gen, device=dev) > 0.3
                    ).float()
            kw = dict(beta=0.999, scale=1.0 - 0.999, sr_seed=sr)
            got = cs_ema_tiled(S.clone(), b, s, x, mask, **kw)
            want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
            torch.cuda.synchronize()
            host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
            tag = f"signed={signed} width={width}"
            if not (torch.equal(host[0].view(torch.int16),
                                got[0].cpu().view(torch.int16))
                    and torch.equal(host[1], got[1].cpu())):
                raise AssertionError(f"B3 bf16 not bit-equal to its plain "
                                     f"version on a CPU copy, {tag}")
            differ = int((want[0].view(torch.int16)
                          != got[0].view(torch.int16)).sum())
            if not torch.equal(want[1], got[1]) or (
                    free and differ) or not bf16_within(got[0], want[0],
                                                        COLLISION_ATOL):
                raise AssertionError(f"B3 bf16 against the plain version "
                                     f"on the card, {tag}: {differ} cells "
                                     f"differ")
            report.append(f"{tag}: {differ} of {S.numel()} cells differ")
    log(f"phase 2: B3 cs_ema_tiled bf16 k={k} d={D_MODEL}, Adam form, mask "
        f"on: bit-equal (cells and est) to the plain version on a CPU copy "
        f"in all four cases; against it on the card est bit-equal, cells "
        f"within one bf16 ulp + {COLLISION_ATOL}: {'; '.join(report)}")


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
    from repro_torch.core.optimizers import SketchHParams, adam
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

    def loss_on(idx, tab=None) -> float:
        rows = (table if tab is None else tab)[idx] - target[idx]
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
    if counts["cs_adam_tiled"] != STEPS or counts["cs_update"] != STEPS \
            or counts["bucket_csr"] != STEPS:
        raise AssertionError(f"the main path did not launch B1, its CSR and "
                             f"the dedup sum (B5) once a step: {counts}")
    if not held_after < held_before:
        raise AssertionError("the loss did not fall")
    if not (torch.isfinite(table).all() and torch.isfinite(state["m"]).all()
            and torch.isfinite(state["v"]).all()):
        raise AssertionError("non-finite table or sketch")
    phase_witness(dev, table0, target, batches, table, losses)
    phase_repeat(dev, step_fn, opt, table0, target, batches, table, state,
                 losses)
    phase_dense_vs_sparse(dev, table0, target, batches, table, losses)
    dense_table = run_dense(adam(LR), table0, target, batches, dev)[0]
    log(f"phase 3e: dense Adam (optimizers.adam, lr {LR}) on the same "
        f"{STEPS} batches: loss on the first batch's ids {held_before} -> "
        f"{loss_on(held, dense_table)}, on a fresh zipf batch "
        f"{fresh_before} -> {loss_on(fresh, dense_table)}; CS-Adam (phase "
        f"3): {held_before} -> {held_after}, {fresh_before} -> "
        f"{fresh_after}")
    del table0, dense_table
    more = zipf_ids(np.random.RandomState(seed + 30), 5)
    table, state, _, _ = profile_steps(
        "phase 3c", lambda: run_steps(step_fn, table, target, state, more,
                                      dev), statistics.median(ms[1:]),
        by_name=True)
    return (table, target, state, batches[-1], counts,
            (held_before, held_after))


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
    table, _state, losses, ms = run_steps(step_fn, table0.clone(), target,
                                          opt.init(), batches, dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, losses))
    err = float((table - tiled_table).abs().max())
    bit = losses == tiled_losses and torch.equal(table, tiled_table)
    log(f"phase 3b: plain xla, same {len(batches)} batches at full width: "
        f"ms/step median {statistics.median(ms[1:])}; per-step batch loss "
        f"{losses}")
    log(f"phase 3b: tiled vs plain xla: per-batch loss max rel diff {rel}, "
        f"table max_abs_err {err} (rtol {WITNESS_TOL['rtol']}, atol "
        f"{WITNESS_TOL['atol']}); losses and table equal to the bit {bit}")
    torch.testing.assert_close(torch.tensor(tiled_losses),
                               torch.tensor(losses), rtol=WITNESS_TOL["rtol"],
                               atol=0.0)
    torch.testing.assert_close(tiled_table, table, **WITNESS_TOL)


def phase_repeat(dev, step_fn, opt, table0, target, batches, table, state,
                 losses):
    """3f: phase 3's batches again from the same start: the table, both
    sketches and the losses must be phase 3's to the bit.  Then one more
    step of that copy under ``torch.cuda.set_sync_debug_mode("error")``:
    a step that waited for the device would raise."""
    import torch
    t2, s2, losses2, _ = run_steps(step_fn, table0.clone(), target,
                                   opt.init(), batches, dev)
    same = {"table": torch.equal(table, t2),
            "m": torch.equal(state["m"], s2["m"]),
            "v": torch.equal(state["v"], s2["v"]),
            "losses": losses == losses2}
    log(f"phase 3f: phase 3's {len(batches)} tiled steps again from the "
        f"same start: equal to the bit {same}")
    if not all(same.values()):
        raise AssertionError(f"two runs of the tiled steps differ: {same}")
    ids = torch.from_numpy(batches[0]).to(dev)
    rows = t2[ids.long()] - target[ids.long()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn(t2, s2, ids, rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 3f: one tiled step under torch.cuda.set_sync_debug_mode("
        "'error'): no host-device synchronisation")


def run_dense(opt, table0, target, batches, dev):
    """The main path's batches from ``table0`` as dense gradients: each
    step's rows ``table[ids] - target[ids]`` summed into a zero table.
    Returns (table, per-batch losses)."""
    import torch
    from repro_torch.core.optimizers import apply_updates
    params = {"table": table0.clone()}
    state = opt.init(params)
    losses = []
    for ids_np in batches:
        idx = torch.from_numpy(ids_np).to(dev).long()
        rows = params["table"][idx] - target[idx]
        losses.append(torch.mean(rows * rows))
        grad = torch.zeros_like(params["table"]).index_add_(0, idx, rows)
        updates, state = opt.update({"table": grad}, state)
        apply_updates(params, updates)
    torch.cuda.synchronize()
    return params["table"], [float(x) for x in losses]


def phase_dense_vs_sparse(dev, table0, target, batches, tiled_table,
                          tiled_losses):
    """The main path's batches as dense gradients through
    ``adam_from_stores`` with the main path's stores pinned to ``auto``
    (B3): the same step as the sparse-rows path, so the same table."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, adam_from_stores
    from repro_torch.core.stores import StoreTree
    from repro_torch.train.steps import sparse_embedding_stores
    m_store, v_store = sparse_embedding_stores(VOCAB, D_MODEL,
                                               hparams=SketchHParams())
    tree = StoreTree(rules=(("table", m_store, v_store),)).with_backend(
        "auto")
    before = read_counts()["cs_ema_tiled"]
    table, losses = run_dense(adam_from_stores(LR, tree), table0, target,
                              batches, dev)
    launches = read_counts()["cs_ema_tiled"] - before
    rel = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, losses))
    err = float((table - tiled_table).abs().max())
    log(f"phase 3d: the same {len(batches)} batches as dense gradients "
        f"through adam_from_stores (B3 x{launches}): per-batch loss max rel "
        f"diff {rel}, table max_abs_err {err} vs the sparse-rows tiled run")
    if launches != 2 * len(batches):
        raise AssertionError(f"the dense check launched B3 {launches} times")
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(tiled_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    torch.testing.assert_close(table, tiled_table, **WITNESS_TOL)


def kernel_profile(run):
    """``run()``, which synchronises, under ``torch.profiler``.  Returns
    (its result, wall ms, [(device ms, launches, name)] of every device
    operation, most time first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        # a profiler span (``obs.profiling.scope``) also shows on the
        # device, as the time between its first and last kernel: not work
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False) \
                or evt.key.startswith("obs."):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    return out, wall_ms, kernels


def profile_steps(tag: str, run, step_ms: float, n: int = 5,
                  by_name: bool = False):
    """``run()``, which drives ``n`` steps and synchronises, under
    ``torch.profiler``: the device's busy time a step, its launches (device
    operations) a step, and the kernels that take the time (with
    ``by_name``, every kernel's launches a step).  The idle share is taken
    against ``step_ms``, the unprofiled step time, since the profiler slows
    the host.  Returns ``run()``'s result."""
    out, wall_ms, kernels = kernel_profile(run)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms <= 0.0:
        log(f"{tag}: device busy time not measured (the profiler saw no "
            f"CUDA kernels)")
        return out
    launches = sum(k[1] for k in kernels)
    log(f"{tag}: {n} steps under torch.profiler: wall {wall_ms} ms, "
        f"device busy {busy_ms} ms ({busy_ms / n} ms a step); idle share "
        f"{1.0 - busy_ms / n / step_ms} against the unprofiled step of "
        f"{step_ms} ms ({1.0 - busy_ms / wall_ms} with the profiler on); "
        f"{launches / n} launches a step")
    for ms, count, name in kernels[:10]:
        log(f"{tag}:   {ms} ms  x{count}  {name[:90]}")
    if by_name:
        per_step = {name: count / n for _ms, count, name in kernels}
        log(f"{tag}: launches a step by kernel name {json.dumps(per_step)}")
    return out


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
    if stream_counts["bucket_csr"] != 2 * STREAM_STEPS:
        raise AssertionError("the stream path did not find prev on the "
                             "device (two bucket_csr launches a step)")
    if not torch.isfinite(table).all():
        raise AssertionError("non-finite table after phase 4")
    return stream_counts


def phase_sketch_ops(dev, ids_np, seed: int):
    """The batch sketch ops on one main-path batch: ``ops.sketch_update``
    (B5) adds its rows into a zero (3, 10,240, 896) Count-Sketch and
    ``ops.sketch_query`` (B4) reads the batch back.  Both are held to
    their plain versions to the bit, and the most frequent ids must come
    back close to the sum of their rows (heavy hitters survive the
    sketch).
    Returns (spec, sketch, ids, rows, counts)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops, ref
    spec = SketchHParams().spec("sparse_embedding", (VOCAB, D_MODEL),
                                signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    ids = torch.from_numpy(ids_np).to(dev)
    rows = torch.randn((ids.numel(), D_MODEL), generator=gen, device=dev)
    S = torch.zeros(spec.shape, device=dev)
    reset_counts()
    ops.sketch_update(spec, S, ids, rows)
    est = ops.sketch_query(spec, S, ids)
    torch.cuda.synchronize()
    counts = read_counts()
    b, sg = spec.family.bucket(ids), spec.family.sign(ids)
    # the zipf head sums ~1,500 rows into one cell: atomics in the card's
    # index_add_ drift there by many ulps, so B5 is held to its plain
    # version on a CPU copy, which adds in the kernel's order
    plain = ref.cs_update_ref(torch.zeros_like(S), b, sg, rows)
    upd_err = float((plain - S).abs().max())
    host = ref.cs_update_ref(torch.zeros(spec.shape), *on_cpu([b, sg, rows]))
    if not torch.equal(host, S.cpu()):
        raise AssertionError("B5 on the sketch-ops path is not bit-equal to "
                             "its plain version on a CPU copy")
    if not torch.equal(est, ref.cs_query_ref(S, b, sg)):
        raise AssertionError("B4 on the sketch-ops path is not bit-equal")
    uniq, freq = np.unique(ids_np, return_counts=True)
    top = torch.from_numpy(uniq[np.argsort(-freq)[:5]]).to(dev)
    truth = torch.zeros((VOCAB, D_MODEL), device=dev).index_add_(
        0, ids.long(), rows)[top.long()]
    rel = ((ops.sketch_query(spec, S, top) - truth).norm(dim=1)
           / truth.norm(dim=1)).tolist()
    log(f"phase 4: sketch ops on {ids.numel()} ids into {spec.shape}: "
        f"launches {counts}; B5 bit-equal to its plain version on a CPU "
        f"copy (max_abs_err {upd_err} vs it on the card), B4 bit-equal; "
        f"the 5 most frequent ids "
        f"({[int(f) for f in sorted(freq)[-5:][::-1]]} "
        f"times) read back with relative error {rel}")
    if counts["cs_update"] != 1 or counts["cs_query"] != 1 \
            or counts["bucket_csr"] != 1:
        raise AssertionError("the sketch ops did not launch B5 (and its "
                             "CSR) and B4")
    if not max(rel) < 0.5:
        raise AssertionError(f"heavy hitters lost in the sketch: {rel}")
    return spec, S, ids, rows, counts


# ---------------------------------------------------------------- phase 5
def unique_rows(buckets, n_valid: int, width: int) -> int:
    """Distinct (hash row, bucket) pairs among the first n_valid items:
    the sketch rows a step must read and write."""
    import torch
    b = buckets[:, :n_valid].long()
    rows = torch.arange(b.shape[0], device=b.device)[:, None]
    return int((b + width * rows).unique().numel())


def b1_bytes(d: int, k: int, k_u: int, rows_m: int, rows_v: int,
             depth: int, track_m: bool) -> int:
    """B1's bytes, each input read once and each output written once: the
    live gradient rows read, the output rows written, the touched M and V
    rows read and written, the live slots' addressing (M's buckets and
    signs with a first moment, V's buckets), inv, first_pos, n_valid."""
    return (4 * d * (k_u + k) + 4 * d * 2 * (rows_m + rows_v)
            + 4 * ((3 if track_m else 1) * depth * k_u + 2 * k + 1))


def longest_chain(buckets) -> int:
    """The most items of one hash row in one bucket: the longest chain of
    items that B2 must run in order through one cell."""
    import torch
    return int(max(torch.unique(row, return_counts=True)[1].max()
                   for row in buckets)) if buckets.numel() else 0


def phase_times(dev, table, target, state, ids_np, seed: int,
                sketch_ops) -> list:
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import dedup as dd, ops, ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import (at_positions,
                                                   cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    from repro_torch.kernels.cs_update import bucket_prev
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
    pos = (batch.inv, batch.first_pos)
    args = (state["m"], state["v"], bm, sm, bv, batch.rows)
    b1kw = dict(n_valid=batch.n_unique, positions=pos, **kw)
    want = cs_adam_tiled_plain(*clone(args), n_valid=batch.n_unique, **kw)
    got = cs_adam_tiled(*clone(args), **b1kw)
    err = max_err(want[:2], got[:2])
    upd_bit = torch.equal(at_positions(want[2], batch.first_pos), got[2])
    host = cs_adam_tiled(*on_cpu(args), n_valid=batch.n_unique.cpu(),
                         positions=on_cpu(pos), **kw)
    line = b1_vs_cpu(host, got)
    if not (upd_bit and err <= COLLISION_ATOL):
        raise AssertionError(f"B1 at main-path shapes: upd bit-equal to the "
                             f"plain version on the card {upd_bit}, M and V "
                             f"max_abs_err {err}")
    del want, got, host
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_tiled(*scratch, **b1kw), reps=20, warmup=3)
    b1_prof = kernel_profile(
        lambda: [cs_adam_tiled(*scratch, **b1kw) for _ in range(5)]
        + [torch.cuda.synchronize()])[2]
    b1_launches = sum(c for _ms, c, _n in b1_prof) / 5
    b1_parts = {name: t / 5 for t, _c, name in b1_prof}
    plain_ms = cuda_ms(lambda: cs_adam_tiled_plain(
        *scratch, n_valid=batch.n_unique, **kw), reps=5)
    # the tiled backend as the step calls it: ids and rows in, the update
    # per input position out (dedup, hashing, B1)
    def called():
        return ops.adam_rows_tiled(spec_m, spec_v, scratch[0], scratch[1],
                                   ids, rows, STEPS, lr=-1.0)
    called_ms = cuda_ms(called, reps=20, warmup=3)
    _o, _w, prof = kernel_profile(
        lambda: [called() for _ in range(5)] + [torch.cuda.synchronize()])
    called_busy = sum(p[0] for p in prof) / 5
    called_launches = sum(p[1] for p in prof) / 5
    called_top = {name: t / 5 for t, _c, name in prof[:6]}
    depth = spec_v.depth
    k = int(ids.numel())
    rows_m = unique_rows(bm, k_u, spec_m.width)
    rows_v = unique_rows(bv, k_u, spec_v.width)
    nbytes = b1_bytes(D_MODEL, k, k_u, rows_m, rows_v, depth, True)
    out.append(dict(name="cs_adam_tiled", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam_tiled.cu",
                    replaces="src/repro/kernels/cs_adam_tiled.py:153",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k, k_unique=k_u,
                    touched_rows_m=rows_m, touched_rows_v=rows_v,
                    bytes=nbytes, launches_per_call=b1_launches,
                    device_ms_by_kernel=b1_parts, as_called_ms=called_ms,
                    as_called_busy_ms=called_busy,
                    as_called_launches=called_launches))
    log(f"phase 5: B1 k_u={k_u} (of {k}): {ms} ms ({b1_launches} device "
        f"launches a call), plain {plain_ms} ms, bound "
        f"{out[-1]['bound_ms']} ms ({nbytes} B at 3.35 TB/s: 4 B x "
        f"{D_MODEL} x (k_u + k + 2 x ({rows_m} M rows + {rows_v} V rows)) "
        f"+ 4 B x (9 k_u + 2 k + 1)); {line}; M and V max_abs_err {err} vs "
        f"the plain version on the card, upd bit-equal to it")
    log(f"phase 5: B1's device ms a call by kernel {json.dumps(b1_parts)}")
    log(f"phase 5: ops.adam_rows_tiled as called (ids and rows in, the "
        f"update per input position out): {called_ms} ms, device busy "
        f"{called_busy} ms, {called_launches} device launches a call; its "
        f"costliest kernels (ms a call) {json.dumps(called_top)}")
    # B2 at the inputs the stream backend gives it: the raw ids, in order;
    # its time includes the two CSR launches that find each item's prev
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
    ms = cuda_ms(lambda: cs_adam_fused(*scratch, **kw), reps=10, warmup=2)
    prev_ms = cuda_ms(lambda: (bucket_prev(bm, spec_m.width),
                               bucket_prev(bv, spec_v.width)),
                      reps=20, warmup=3)
    k = int(ids.numel())
    nbytes = (4 * D_MODEL * 2 * k
              + 4 * D_MODEL * 2 * (unique_rows(bm, k, spec_m.width)
                                   + unique_rows(bv, k, spec_v.width))
              + 4 * 3 * depth * k)
    chain = max(longest_chain(bm), longest_chain(bv))
    out.append(dict(name="cs_adam_fused", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam.cu",
                    replaces="src/repro/kernels/cs_adam.py:110",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k,
                    k_unique=int(np.unique(ids_np).size), bytes=nbytes,
                    prev_ms=prev_ms, longest_chain=chain))
    log(f"phase 5: B2 k={k}: {ms} ms with its prev pass ({prev_ms} ms of "
        f"it), plain {plain_ms} ms (one run), bound {out[-1]['bound_ms']} "
        f"ms ({nbytes} B at 3.35 TB/s); longest same-bucket chain {chain} "
        f"items; vs plain bit-equal")
    out.append(time_ema(dev, seed))
    out.append(time_ema_bf16(dev, seed))
    out.extend(time_sketch_ops(dev, sketch_ops))
    return out


def time_ema(dev, seed: int) -> dict:
    """B3 as the dense path runs it: all 151,936 rows of the table, the
    Adam first moment (signed, mask all ones), cached addressing."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    spec = SketchHParams().spec("tok_embed/table", (VOCAB, D_MODEL),
                                signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    S = torch.randn(spec.shape, generator=gen, device=dev)
    x = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev)
    mask = torch.ones((VOCAB, 1), device=dev)
    b, s = ops._cached_addressing(spec, VOCAB, dev)
    csr = ops._cached_csr(spec, VOCAB, dev)
    kw = dict(beta=0.9, scale=1.0 - 0.9)
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    got = cs_ema_tiled(S.clone(), b, s, x, mask, csr=csr, **kw)
    card_err = max_err(want, got)
    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
    err = max_err(host, on_cpu(got))
    if err != 0.0 or card_err > COLLISION_ATOL:
        raise AssertionError(f"B3 at the dense path's shapes: {err} vs a "
                             f"CPU copy, {card_err} on the card")
    del want, got, host
    work = S.clone()
    ms = cuda_ms(lambda: cs_ema_tiled(work, b, s, x, mask, csr=csr, **kw),
                 reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: cs_ema_tiled_plain(work, b, s, x, mask, **kw),
                       reps=5)
    slices = time_ema_slices(work, b, s, x, mask, csr, dict(sr_seed=None,
                                                            **kw))
    depth, width, d = spec.shape
    nbytes = 4 * (2 * VOCAB * d + 2 * depth * width * d + 2 * depth * VOCAB
                  + VOCAB)
    row = dict(name="cs_ema_tiled", route="cuda",
               source="src/repro_torch/kernels/csrc/cs_ema_tiled.cu",
               replaces="src/repro/kernels/cs_ema_tiled.py:140",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, k=VOCAB, bytes=nbytes, **slices)
    log(f"phase 5: B3 k={VOCAB} (every row, signed, mask on): {ms} ms, "
        f"plain {plain_ms} ms, bound {row['bound_ms']} ms ({nbytes} B at "
        f"3.35 TB/s); bit-equal to the plain version on a CPU copy, "
        f"max_abs_err {card_err} vs it on the card")
    log_slices("B3", ms, slices)
    return row


def device_ms(fn, n: int = 3):
    """Device time a call of the kernels that ``fn()`` launches, from
    ``torch.profiler``; None where it saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / n if busy > 0.0 else None


def time_ema_slices(work, b, s, x, mask, csr, kw) -> dict:
    """B3's column slices at the shapes of ``work``: the slice width the
    wrapper picks, the number of slices and the scratch bytes; the read
    launches of a call alone and its scatter launches alone, each over
    the number of slices (the time of one slice's read and scatter); the
    device time of a call's kernels (the rest of a call's time is gaps
    between launches); a copy of x into est slice by slice, the DRAM
    traffic of the reads without their work, beside one whole copy; a
    whole call at slice widths 16, 32 and 64 (through ``launch_slices``,
    which counts nothing)."""
    import torch
    from repro_torch.kernels.cs_ema_tiled import (READ, SCATTER,
                                                  launch_slices, slice_cols)
    depth, width, d = work.shape
    k = x.shape[0]
    cols = slice_cols(k, d, depth, width, work.element_size())
    order, starts = csr
    est = torch.empty((k, d), device=x.device)

    def run(c, parts=READ | SCATTER):
        scratch = torch.empty((k, c), device=x.device)
        return lambda: launch_slices(work, b, s, x, mask.reshape(k), order,
                                     starts, est, scratch, parts=parts, **kw)

    def copy_by_slices():  # the DRAM pattern of x and est, alone
        for c0 in range(0, d, cols):
            est[:, c0:c0 + cols].copy_(x[:, c0:c0 + cols])
    slices = -(-d // cols)
    return dict(
        slice_cols=cols, slices=slices, scratch_bytes=4 * k * cols,
        slice_read_ms=cuda_ms(run(cols, READ), reps=10, warmup=2) / slices,
        slice_scatter_ms=cuda_ms(run(cols, SCATTER), reps=10,
                                 warmup=2) / slices,
        busy_ms=device_ms(run(cols)),
        copy_by_slices_ms=cuda_ms(copy_by_slices, reps=5, warmup=1),
        copy_ms=cuda_ms(lambda: est.copy_(x), reps=5, warmup=1),
        call_ms_by_cols={c: cuda_ms(run(c), reps=10, warmup=2)
                         for c in (16, 32, 64)})


def log_slices(name: str, ms: float, sl: dict) -> None:
    apart = sl["slices"] * (sl["slice_read_ms"] + sl["slice_scatter_ms"])
    busy = ("not measured" if sl["busy_ms"] is None
            else f"{sl['busy_ms']} ms")
    log(f"phase 5: {name} in {sl['slices']} slices of {sl['slice_cols']} "
        f"columns, scratch {sl['scratch_bytes']} B; one slice (a call's "
        f"launches of each kind over its slices): read "
        f"{sl['slice_read_ms']} ms, scatter {sl['slice_scatter_ms']} ms "
        f"({apart} ms over all slices timed apart, against {ms} ms a "
        f"call); the call's kernels busy {busy} of it (profiler); x "
        f"copied into est slice by slice {sl['copy_by_slices_ms']} ms, in "
        f"one copy {sl['copy_ms']} ms; a call at slice widths 16/32/64: "
        f"{sl['call_ms_by_cols']}")


def time_ema_bf16(dev, seed: int) -> dict:
    """B3's bf16 branch as the dense path runs it with bf16 cells: all
    151,936 rows, the signed first moment, mask on, cached addressing.
    Its bound counts x read and est written (4 B each), the bf16 sketch
    read and written once (2 B a cell) and the addressing and mask."""
    import torch
    from repro_torch.core import quantize as qz
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    spec = SketchHParams(dtype="bfloat16").spec(
        "tok_embed/table", (VOCAB, D_MODEL), signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 61)
    S = torch.randn(spec.shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev)
    mask = torch.ones((VOCAB, 1), device=dev)
    b, s = ops._cached_addressing(spec, VOCAB, dev)
    csr = ops._cached_csr(spec, VOCAB, dev)
    kw = dict(beta=0.9, scale=1.0 - 0.9, sr_seed=qz.step_seed(spec.seed, 3))
    got = cs_ema_tiled(S.clone(), b, s, x, mask, csr=csr, **kw)
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    card_differ = int((want[0].view(torch.int16)
                       != got[0].view(torch.int16)).sum())
    card_ok = torch.equal(want[1], got[1]) and bf16_within(
        got[0], want[0], COLLISION_ATOL)
    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
    bit = (torch.equal(host[0].view(torch.int16),
                       got[0].cpu().view(torch.int16))
           and torch.equal(host[1], got[1].cpu()))
    err = max(float((host[0].float() - got[0].cpu().float()).abs().max()),
              float((host[1] - got[1].cpu()).abs().max()))
    if not (bit and card_ok):
        raise AssertionError(f"B3 bf16 at the dense path's shapes: "
                             f"bit-equal to a CPU copy {bit}; on the card "
                             f"{card_differ} cells differ")
    del want, got, host
    work = S.clone()
    ms = cuda_ms(lambda: cs_ema_tiled(work, b, s, x, mask, csr=csr, **kw),
                 reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: cs_ema_tiled_plain(work, b, s, x, mask, **kw),
                       reps=5)
    slices = time_ema_slices(work, b, s, x, mask, csr, kw)
    depth, width, d = spec.shape
    nbytes = (4 * 2 * VOCAB * d + 2 * 2 * depth * width * d
              + 4 * (2 * depth * VOCAB + VOCAB))
    row = dict(name="cs_ema_tiled_bf16", route="cuda",
               source="src/repro_torch/kernels/csrc/cs_ema_tiled.cu",
               replaces="src/repro/kernels/cs_ema_tiled.py:140",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, k=VOCAB, bytes=nbytes, **slices)
    log(f"phase 5: B3 bf16 k={VOCAB} (every row, signed, mask on): {ms} ms, "
        f"plain {plain_ms} ms, bound {row['bound_ms']} ms ({nbytes} B at "
        f"3.35 TB/s); bit-equal to the plain version on a CPU copy; "
        f"{card_differ} of {S.numel()} cells round apart from it on the "
        f"card (atomic-order sums), est bit-equal")
    log_slices("B3 bf16", ms, slices)
    return row


def time_sketch_ops(dev, sketch_ops) -> list:
    """B4 and B5 at the sketch-ops phase's shapes: 16,384 zipf ids into
    the (3, 10,240, 896) Count-Sketch.  B5's library yardstick is one
    ``index_add_`` on the flattened (depth*width, dim) sketch with the
    signed rows already formed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import (bucket_csr, bucket_csr_plain,
                                               cs_update)
    spec, S, ids, rows, counts = sketch_ops
    depth, width, d = spec.shape
    k = ids.numel()
    b, s = spec.family.bucket(ids), spec.family.sign(ids)
    touched = unique_rows(b, k, width)
    out = []
    ms = cuda_ms(lambda: cs_query(S, b, s), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: ref.cs_query_ref(S, b, s), reps=10)
    nbytes = 4 * (k * d + touched * d + 2 * depth * k)
    out.append(dict(name="cs_query", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_query.cu",
                    replaces="src/repro/kernels/cs_query.py:58",
                    launches=counts["cs_query"], max_abs_err=0.0, ms=ms,
                    plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k,
                    touched_rows=touched, bytes=nbytes))
    log(f"phase 5: B4 k={k} ({touched} sketch rows): {ms} ms, plain "
        f"{plain_ms} ms, bound {out[-1]['bound_ms']} ms ({nbytes} B)")
    # B5 as users call it (the CSR built in the call), then its parts
    work = S.clone()
    ms = cuda_ms(lambda: cs_update(work, b, s, rows), reps=20, warmup=3)
    csr = bucket_csr(b, width)
    scatter_ms = cuda_ms(lambda: cs_update(work, b, s, rows, csr=csr),
                         reps=20, warmup=3)
    csr_ms = cuda_ms(lambda: bucket_csr(b, width), reps=20, warmup=3)
    csr_plain_ms = cuda_ms(lambda: bucket_csr_plain(b, width), reps=20,
                           warmup=3)
    sort_ms = cuda_ms(lambda: torch.sort(b, dim=1, stable=True), reps=20,
                      warmup=3)
    plain_ms = cuda_ms(lambda: ref.cs_update_ref(work, b, s, rows), reps=10)
    flat = work.view(depth * width, d)
    idx = (b.long() + width * torch.arange(depth, device=dev)[:, None]
           ).reshape(-1)
    signed_rows = (s[:, :, None] * rows[None]).reshape(depth * k, d)
    library_ms = cuda_ms(lambda: flat.index_add_(0, idx, signed_rows),
                         reps=20, warmup=3)
    got = cs_update(S.clone(), b, s, rows)
    card_err = float((ref.cs_update_ref(S.clone(), b, s, rows) - got).abs()
                     .max())
    err = float((ref.cs_update_ref(*on_cpu([S, b, s, rows])) - got.cpu())
                .abs().max())
    if err != 0.0:
        raise AssertionError(f"B5 at the sketch ops' shapes: {err} vs a "
                             f"CPU copy")
    if not all(torch.equal(a, c) for a, c in
               zip(bucket_csr_plain(b, width)[:2], csr)):
        raise AssertionError("bucket_csr at the sketch ops' shapes differs "
                             "from the plain form")
    nbytes = 4 * (k * d + 2 * touched * d + 2 * depth * k)
    out.append(dict(name="cs_update", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_update.cu",
                    replaces="src/repro/kernels/cs_update.py:58",
                    max_abs_err=err, ms=ms,
                    plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=library_ms, k=k,
                    touched_rows=touched, bytes=nbytes, csr_ms=csr_ms,
                    scatter_ms=scatter_ms))
    log(f"phase 5: B5 k={k} as called (CSR built in the call): {ms} ms "
        f"(CSR alone {csr_ms}, scatter alone {scatter_ms}), plain "
        f"{plain_ms} ms, index_add_ {library_ms} ms, bound "
        f"{out[-1]['bound_ms']} ms ({nbytes} B); bit-equal to the plain "
        f"version on a CPU copy, max_abs_err {card_err} vs it on the card")
    if not ms < library_ms:
        log(f"phase 5: B5 ({ms} ms) is not faster than one index_add_ "
            f"({library_ms} ms)")
    csr_bytes = 4 * (2 * depth * k + depth * (width + 1))
    out.append(dict(name="bucket_csr", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_csr.cu",
                    replaces=None, max_abs_err=0.0, ms=csr_ms,
                    plain_ms=csr_plain_ms,
                    bound_ms=csr_bytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=sort_ms, k=k,
                    bytes=csr_bytes))
    log(f"phase 5: bucket_csr ({depth}, {k}) buckets, width {width}: "
        f"{csr_ms} ms, plain (stable torch.sort + searchsorted) "
        f"{csr_plain_ms} ms, one stable torch.sort (order only) {sort_ms} "
        f"ms, bound {out[-1]['bound_ms']} ms ({csr_bytes} B); integer-equal "
        f"to the plain form")
    return out


# ---------------------------------------------------------------- phase 6
def softmax_batches(rng: np.random.RandomState, steps: int) -> list:
    return [((rng.zipf(ZIPF_A, TOKENS) - 1) % VOCAB).astype(np.int64)
            for _ in range(steps)]


class SoftmaxTask:
    """The softmax layer of qwen2-0.5b on the dense path (phases 6 and 7):
    ``{"tok_embed": {"table"}, "final_norm": {"scale"}}``, cross-entropy of
    ``rmsnorm(h)*scale @ table^T`` over all 151,936 classes, ``h =
    teacher[y] + noise``, 1,024 zipf(1.1) targets a step."""

    def __init__(self, dev, seed: int):
        import torch
        self.dev = dev
        gen = torch.Generator(device=dev).manual_seed(seed + 50)
        self.teacher = torch.randn((VOCAB, D_MODEL), generator=gen,
                                   device=dev)
        self.table0 = torch.randn((VOCAB, D_MODEL), generator=gen,
                                  device=dev) / D_MODEL ** 0.5
        self.batches = softmax_batches(np.random.RandomState(seed), STEPS)
        self.noise = [torch.randn((TOKENS, D_MODEL), generator=gen,
                                  device=dev) for _ in self.batches]
        self.fresh_y = softmax_batches(np.random.RandomState(seed + 99), 1)[0]
        self.fresh_noise = torch.randn((TOKENS, D_MODEL), generator=gen,
                                       device=dev)

    def loss_fn(self, params, y_np, eps_h):
        import torch
        y = torch.from_numpy(y_np).to(self.dev)
        h = self.teacher[y] + eps_h
        hn = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6) \
            * params["final_norm"]["scale"]
        return torch.nn.functional.cross_entropy(
            hn @ params["tok_embed"]["table"].t(), y)

    def run(self, opt, lr, steps: int = STEPS, before=None):
        """``steps`` steps from table0; returns (params, state, per-step
        losses, per-step ms, the step function, per-step max
        |direction|).  ``before(state, step)`` runs ahead of each step
        and returns the state (the async cleaner's hook)."""
        import torch
        from repro_torch.core.optimizers import apply_updates
        dev = self.dev
        params = {"tok_embed": {"table": self.table0.clone()
                                .requires_grad_()},
                  "final_norm": {"scale": torch.ones(
                      D_MODEL, device=dev).requires_grad_()}}
        state = opt.init(params)
        leaves = (params["tok_embed"]["table"], params["final_norm"]["scale"])
        directions = []

        def step(y_np, eps_h):
            nonlocal state
            loss = self.loss_fn(params, y_np, eps_h)
            g_table, g_scale = torch.autograd.grad(loss, leaves)
            updates, state = opt.update(
                {"tok_embed": {"table": g_table},
                 "final_norm": {"scale": g_scale}}, state)
            directions.append(updates["tok_embed"]["table"].abs().max()
                              / lr)
            apply_updates(params, updates)
            return loss.detach()

        losses, events = [], []
        for i, (y_np, eps_h) in enumerate(zip(self.batches[:steps],
                                              self.noise)):
            if before is not None:
                state = before(state, i + 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(y_np, eps_h))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return (params, state, [float(x) for x in losses],
                [a.elapsed_time(b) for a, b in events], step,
                [float(x) for x in directions])

    def held_fresh(self, params=None):
        """The loss on batch 0's tokens and on a fresh batch."""
        import torch
        if params is None:
            params = {"tok_embed": {"table": self.table0},
                      "final_norm": {"scale": torch.ones(D_MODEL,
                                                         device=self.dev)}}
        with torch.no_grad():
            return (float(self.loss_fn(params, self.batches[0],
                                       self.noise[0])),
                    float(self.loss_fn(params, self.fresh_y,
                                       self.fresh_noise)))


def phase_dense(dev, seed: int):
    """The dense-gradient path at full width (see the module docstring).
    Returns (the kernel launch counts of its 20 checked steps, the task,
    its per-step losses)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, adam, \
        countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    task = SoftmaxTask(dev, seed)
    noise, run, held_fresh = task.noise, task.run, task.held_fresh
    held0, fresh0 = held_fresh()
    policy = SketchPolicy()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, state, losses, ms, step, dirs = run(
        countsketch_adam(DENSE_LR, policy=policy,
                         hparams=SketchHParams(backend="auto")), DENSE_LR)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    held, fresh = held_fresh(params)
    m = state["m"]["tok_embed"]["table"]
    log(f"phase 6: softmax layer tok_embed/table {VOCAB} x {D_MODEL}, "
        f"{TOKENS} zipf({ZIPF_A}) targets a step; sketches m "
        f"{tuple(m.shape)} v {tuple(state['v']['tok_embed']['table'].shape)}"
        f" ({m.numel() * 4} B each), final_norm/scale dense Adam; "
        f"countsketch_adam lr {DENSE_LR}")
    log(f"phase 6: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (first step {ms[0]}); all {ms}; "
        f"peak device memory {peak} B")
    log(f"phase 6: loss on batch 0's tokens {held0} -> {held}; on a fresh "
        f"batch {fresh0} -> {fresh}; per-step {losses}; max |direction| "
        f"per step {dirs}; launches {counts}")
    if counts["cs_ema_tiled"] != 2 * STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times, "
                             f"not {2 * STEPS}")
    if not held < held0:
        raise AssertionError("the dense path's loss did not fall")
    if not all(torch.isfinite(t).all() for t in (
            params["tok_embed"]["table"], m,
            state["v"]["tok_embed"]["table"])):
        raise AssertionError("non-finite table or sketch")
    w_params, _, w_losses, w_ms, _, _ = run(
        countsketch_adam(DENSE_LR, policy=policy,
                         hparams=SketchHParams(backend="xla")), DENSE_LR)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
    table, w_table = (params["tok_embed"]["table"].detach(),
                      w_params["tok_embed"]["table"].detach())
    err = float((table - w_table).abs().max())
    log(f"phase 6b: plain xla, same batches: ms/step median "
        f"{statistics.median(w_ms[1:])}; per-step loss max rel diff {rel}, "
        f"table max_abs_err {err} (rtol {WITNESS_TOL['rtol']}, atol "
        f"{WITNESS_TOL['atol']})")
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    torch.testing.assert_close(table, w_table, **WITNESS_TOL)
    del w_params, w_table
    more = softmax_batches(np.random.RandomState(seed + 30), 5)

    def five():
        out = [step(y, eps) for y, eps in zip(more, noise)]
        torch.cuda.synchronize()
        return out
    profile_steps("phase 6c", five, statistics.median(ms[1:]))
    del params, state
    # at the main path's lr the sketched first moment diverges here; the
    # same batches with it dense (CS-V) and all-dense Adam show which part
    # of the sketch does it (printed, not required)
    for name, opt in (
            ("countsketch_adam", countsketch_adam(
                LR, policy=policy, hparams=SketchHParams(backend="auto"))),
            ("countsketch_adam sketch_first_moment=False", countsketch_adam(
                LR, policy=policy, hparams=SketchHParams(backend="auto"),
                sketch_first_moment=False)),
            ("adam (dense)", adam(LR))):
        p, _, l, _, _, d = run(opt, LR)
        h, f = held_fresh(p)
        log(f"phase 6d: {name} lr {LR}: loss on batch 0's tokens {held0} "
            f"-> {h}, fresh {fresh0} -> {f}; per-step {l}; max |direction| "
            f"per step {d}")
        del p
    return counts, task, losses, (held0, held), statistics.median(ms[1:])


# ---------------------------------------------------------------- phase 7
def sketch_bytes(state) -> int:
    """Bytes of one sketch state: its cells, and an int8 state's scales."""
    return sum(t.numel() * t.element_size()
               for t in (state if isinstance(state, tuple) else (state,)))


def phase_dense_bf16(dev, f32):
    """Phase 6's task with bf16 sketch cells: 20 steps of
    ``countsketch_adam(SketchHParams(dtype="bfloat16"))`` on ``auto``, B3's
    bf16 kernel twice a step, the plain ``xla`` witness on the same
    batches, and the losses beside phase 6's f32 run.  Returns the
    launch counts."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    _counts6, task, losses6, (held0, held6), ms6 = f32
    hp = SketchHParams(backend="auto", dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, state, losses, ms, step, dirs = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(), hparams=hp),
        DENSE_LR)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    held, fresh = task.held_fresh(params)
    m, v = state["m"]["tok_embed"]["table"], state["v"]["tok_embed"]["table"]
    nbytes = sketch_bytes(m)
    spec = hp.spec("tok_embed/table", (VOCAB, D_MODEL), signed=True)
    f32_bytes = SketchHParams().spec("tok_embed/table", (VOCAB, D_MODEL),
                                     signed=True).nbytes()
    log(f"phase 7: phase 6's softmax layer with bf16 sketch cells "
        f"(SketchHParams(dtype='bfloat16'), backend auto): sketches m "
        f"{tuple(m.shape)} {m.dtype} v {tuple(v.shape)} {v.dtype}, "
        f"{nbytes} B per moment (f32: {f32_bytes} B)")
    log(f"phase 7: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (f32, phase 6: {ms6}; first step "
        f"{ms[0]}); all {ms}; peak device memory {peak} B")
    log(f"phase 7: loss on batch 0's tokens {held0} -> {held} (f32: "
        f"{held0} -> {held6}); fresh batch {fresh}; per-step {losses}; f32 "
        f"per-step {losses6}; max |direction| per step {dirs}; launches "
        f"{counts}")
    if counts["cs_ema_tiled_bf16"] != 2 * STEPS or counts["cs_ema_tiled"]:
        raise AssertionError(f"bf16 dense path launches {counts}, not "
                             f"{2 * STEPS} of B3 bf16 alone")
    if nbytes != spec.nbytes() or 2 * nbytes != f32_bytes:
        raise AssertionError(f"bf16 sketch bytes {nbytes}, spec "
                             f"{spec.nbytes()}, f32 {f32_bytes}")
    if not held < held0:
        raise AssertionError("the bf16 dense path's loss did not fall")
    if not all(torch.isfinite(t.float()).all() for t in (
            params["tok_embed"]["table"], m, v)):
        raise AssertionError("non-finite table or bf16 sketch")
    w_params, _, w_losses, w_ms, _, _ = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(),
                         hparams=SketchHParams(backend="xla",
                                               dtype="bfloat16")), DENSE_LR)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
    table, w_table = (params["tok_embed"]["table"].detach(),
                      w_params["tok_embed"]["table"].detach())
    diff = (table - w_table).abs()
    outside = int((diff > WITNESS_TOL["atol"]
                   + WITNESS_TOL["rtol"] * w_table.abs()).sum())
    log(f"phase 7: plain xla witness with bf16 cells, same batches: ms/step "
        f"median "
        f"{statistics.median(w_ms[1:])}; per-step loss max rel diff {rel} "
        f"(rtol {WITNESS_TOL['rtol']}); table max_abs_err "
        f"{float(diff.max())}, {outside} of {diff.numel()} entries outside "
        f"rtol {WITNESS_TOL['rtol']}/atol {WITNESS_TOL['atol']} (the plain "
        f"version sums each cell's increments in atomic order, so some "
        f"stochastic roundings go the other way; not asserted)")
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    del w_params, w_table, diff
    more = softmax_batches(np.random.RandomState(31), 5)

    def five():
        out = [step(y, eps) for y, eps in zip(more, task.noise)]
        torch.cuda.synchronize()
        return out
    profile_steps("phase 7 (profile)", five, statistics.median(ms[1:]))
    return counts


def phase_dense_int8(dev, task):
    """Phase 6's task with int8 sketch cells through the plain route: 5
    steps; the table stays finite, the loss on batch 0's tokens falls,
    and no B3 launches (int8 runs ``xla``, as in the reference)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    hp = SketchHParams(backend="auto", dtype="int8")
    reset_counts()
    params, state, losses, ms, _, dirs = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(), hparams=hp),
        DENSE_LR, steps=5)
    counts = read_counts()
    held0, _ = task.held_fresh()
    held, _ = task.held_fresh(params)
    m, v = state["m"]["tok_embed"]["table"], state["v"]["tok_embed"]["table"]
    log(f"phase 7b: int8 sketch cells (SketchHParams(dtype='int8'), backend "
        f"auto -> xla): 5 steps, ms/step {ms}; loss on batch 0's tokens "
        f"{held0} -> {held}; per-step {losses}; max |direction| {dirs}; "
        f"state bytes per moment {sketch_bytes(m)} (cells "
        f"{tuple(m.cells.shape)} int8 + scales {tuple(m.scales.shape)} f32); "
        f"launches {counts}")
    if counts["cs_ema_tiled"] or counts["cs_ema_tiled_bf16"]:
        raise AssertionError(f"int8 cells launched B3: {counts}")
    if not held < held0:
        raise AssertionError("the int8 dense path's loss did not fall")
    if not (torch.isfinite(params["tok_embed"]["table"]).all()
            and torch.isfinite(m.scales).all()
            and torch.isfinite(v.scales).all()):
        raise AssertionError("non-finite table or int8 scales")
    if sketch_bytes(m) != hp.spec("tok_embed/table", (VOCAB, D_MODEL),
                                  signed=True).nbytes():
        raise AssertionError("int8 state bytes disagree with the spec")


def phase_sparse_bf16(dev, seed: int, held3):
    """bf16 cells on phase 3's sparse-rows batches, backend ``tiled``:
    low-precision cells run the whole-batch ``xla`` form as in the
    reference, so no B1 launches; its colliding sums go through B5.
    Prints the held loss beside phase 3's.  The 20 steps run twice from
    the same start must give the same table and sketches to the bit
    (stochastic rounding turns any change of sum order into a whole
    bf16 ulp)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    init_fn, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="tiled", dtype="bfloat16"))
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    batches = zipf_ids(np.random.RandomState(seed), STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()

    def loss_on(tab) -> float:
        rows = tab[held] - target[held]
        return float(torch.mean(rows * rows))

    before = loss_on(table0)
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table0.clone(), target,
                                         opt.init(), batches, dev)
    counts = read_counts()
    after = loss_on(table)
    table2, state2, losses2, _ = run_steps(step_fn, table0, target,
                                           opt.init(), batches, dev)
    same = {"table": torch.equal(table, table2),
            "m": torch.equal(state["m"].view(torch.int16),
                             state2["m"].view(torch.int16)),
            "v": torch.equal(state["v"].view(torch.int16),
                             state2["v"].view(torch.int16)),
            "losses": losses == losses2}
    log(f"phase 7c: phase 3's {STEPS} sparse-rows batches with bf16 sketch "
        f"cells ({state['v'].dtype}, {sketch_bytes(state['v'])} B per "
        f"moment), backend tiled: ms/step median {statistics.median(ms[1:])}; "
        f"loss on the first batch's ids {before} -> {after} (f32, phase 3: "
        f"{held3[0]} -> {held3[1]}); launches {counts}; run twice from the "
        f"same start, equal to the bit {same}")
    if counts["cs_adam_tiled"]:
        raise AssertionError(f"bf16 sparse rows launched B1: {counts}")
    if counts["cs_update"] != 3 * STEPS:
        raise AssertionError(f"bf16 sparse rows: {counts['cs_update']} B5 "
                             f"launches, not 3 a step (the dedup sum and "
                             f"both moments)")
    if not all(same.values()):
        raise AssertionError(f"two runs of the bf16 sparse steps differ: "
                             f"{same}")
    if not after < before:
        raise AssertionError("the bf16 sparse path's loss did not fall")
    if not torch.isfinite(table).all():
        raise AssertionError("non-finite table")


def phase_async_clean(dev, task):
    """The dense path with a Count-Min cleaned every 5 steps (bf16 cells),
    10 steps, sync against ``AsyncCleaner``: the table and both sketches
    must be equal to the bit."""
    import torch
    from repro_torch.core.cleaning import AsyncCleaner, CleaningSchedule
    from repro_torch.core.optimizers import (SketchHParams, adam_from_stores,
                                             stores_from_policy)
    from repro_torch.core.partition import SketchPolicy
    path = ("tok_embed", "table")

    def run(mode):
        sched = CleaningSchedule(alpha=0.5, every=5, mode=mode)
        tree = stores_from_policy(SketchPolicy(), cleaning=sched,
                                  hparams=SketchHParams(backend="auto",
                                                        dtype="bfloat16"))
        cleaner = None
        before = None
        if mode == "async":
            cleaner = AsyncCleaner(
                sched, getter=lambda st: st["v"][path[0]][path[1]])

            def before(state, step):
                return cleaner.maybe_dispatch(state, step)[0]
        params, state, losses, ms, _, _ = task.run(
            adam_from_stores(DENSE_LR, tree), DENSE_LR, steps=10,
            before=before)
        out = [params["tok_embed"]["table"].detach(),
               state["m"][path[0]][path[1]], state["v"][path[0]][path[1]]]
        return out, losses, ms, cleaner

    sync, s_losses, s_ms, _ = run("sync")
    asyn, a_losses, a_ms, cleaner = run("async")
    equal = [torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                         else a, b.view(torch.int16)
                         if b.dtype == torch.bfloat16 else b)
             for a, b in zip(sync, asyn)]
    log(f"phase 7d: bf16 dense path, CountMinStore cleaning alpha 0.5 every "
        f"5, 10 steps: sync ms/step {s_ms}; async ms/step {a_ms}; "
        f"{cleaner.dispatched} async decays, in flight after the run "
        f"{cleaner.in_flight()}; equal to the bit (table, m, v) {equal}; "
        f"losses sync {s_losses} async {a_losses}")
    if cleaner.dispatched != 2:
        raise AssertionError(f"{cleaner.dispatched} async decays, not 2")
    if not all(equal):
        again, _, _, _ = run("sync")
        repeat = [torch.equal(a, b) for a, b in zip(sync, again)]
        raise AssertionError(
            f"async cleaning differs from sync {equal}; sync against a "
            f"second sync run {repeat}: "
            + ("the dense step itself is not deterministic (autograd's "
               "matmul or cross-entropy backward)" if not all(repeat)
               else "the side-stream decay is not ordered before the step"))


# ---------------------------------------------------------------- phase 8
# the reference's full scale, benchmarks/extreme_scale.py:191-194
EXTREME = dict(n_classes=8_000_000, n_meta=1 << 21, n_features=1 << 16,
               dim=64, nnz=16, n_negatives=1_024)
X_BATCH, X_BIG_BATCH, X_LR, X_STEPS = 1_024, 8_192, 1e-2, 20


def extreme_batches(cfg, cmap, batch: int, steps: int, dev,
                    first: int = 0) -> list:
    """Replica batches ``first ..`` from the port's ``ExtremeStream``,
    labels and negatives mapped through the replica's class map, on the
    card."""
    from repro_torch.data import ExtremeStream
    from repro_torch.train.extreme import MetaStream
    stream = MetaStream(ExtremeStream(cfg.data_config(batch)), cmap, dev)
    return [stream.batch(i) for i in range(first, first + steps)]


def run_extreme(step_fn, params, state, batches):
    """Drive the extreme step over ``batches``; returns (params, state,
    losses, per-step ms)."""
    import torch
    losses, events = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, b)
        end.record()
        losses.append(metrics["loss"])
        events.append((start, end))
    torch.cuda.synchronize()
    return (params, state, [float(x) for x in losses],
            [s.elapsed_time(e) for s, e in events])


def loss_windows(losses) -> tuple:
    """The reference launcher's check (``src/repro/launch/train.py:390,
    :402``): the means of the first and the last w losses, w = max(1,
    min(10, steps // 3)); the loss fell when the second is below."""
    w = max(1, min(10, len(losses) // 3))
    return float(np.mean(losses[:w])), float(np.mean(losses[-w:]))


def tables_of(params) -> list:
    return [params["tok_embed"]["table"], params["class_head"]["table"]]


def params_from(tables) -> dict:
    return {"tok_embed": {"table": tables[0].clone()},
            "class_head": {"table": tables[1].clone()}}


def extreme_step(cfg, dev, **kw):
    """(step_fn, opts, fresh state) of ``make_extreme_step``."""
    from repro_torch.train.extreme import make_extreme_step
    _init, step_fn, opts = make_extreme_step(cfg, lr=X_LR, device=dev, **kw)
    return step_fn, opts, {p: o.init() for p, o in opts.items()}


def phase_extreme(dev, seed: int):
    """Phase 8: the MACH extreme-classification step at the reference's
    full scale (see the module docstring).  Returns what phase 5's
    extreme rows and the kernels' line need, and the peak device memory
    before 8e reset its counter."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.extreme import MachConfig, make_extreme_step
    cfg = MachConfig(**EXTREME)
    t0 = time.perf_counter()
    maps = cfg.class_maps()
    backend = kernels.resolve_backend(SketchHParams().backend, dev)
    log(f"phase 8: MachConfig {EXTREME}, {cfg.n_replicas} replicas, batch "
        f"{X_BATCH}, lr {X_LR}, SketchHParams(compression=100.0), backend "
        f"auto -> {backend}; class maps {maps.shape} {maps.dtype} hashed "
        f"on the host in {time.perf_counter() - t0:.1f} s")
    if backend != "tiled":
        raise AssertionError(f"auto resolved to {backend!r} on the card")
    counts_8a, start, final = {}, None, None
    for r in range(cfg.n_replicas):
        init_fn, step_fn, opts = make_extreme_step(
            cfg, optimizer="cs_rmsprop", lr=X_LR, device=dev)
        params = init_fn(torch.Generator(device=dev).manual_seed(seed + r))
        state = {p: o.init() for p, o in opts.items()}
        batches = extreme_batches(cfg, maps[r], X_BATCH, X_STEPS, dev)
        if r == 0:
            start, batches0 = [t.clone() for t in tables_of(params)], batches
            log(f"phase 8: tables tok_embed {tuple(start[0].shape)} "
                f"{start[0].numel() * 4} B, class_head "
                f"{tuple(start[1].shape)} {start[1].numel() * 4} B; V "
                + ", ".join(f"{p} {tuple(s['v'].shape)} "
                            f"{sketch_bytes(s['v'])} B"
                            for p, s in state.items()))
        torch.cuda.synchronize()
        reset_counts()
        params, state, losses, ms = run_extreme(step_fn, params, state,
                                                batches)
        counts = read_counts()
        for name, n in counts.items():
            counts_8a[name] = counts_8a.get(name, 0) + n
        first, last = loss_windows(losses)
        log(f"phase 8a: replica {r} cs_rmsprop {X_STEPS} steps: ms/step "
            f"median of steps 2..{X_STEPS} {statistics.median(ms[1:])} "
            f"(first {ms[0]}); loss first {losses[0]} last {losses[-1]}; "
            f"mean of the first/last {max(1, min(10, X_STEPS // 3))} "
            f"{first} -> {last}; launches {counts}")
        log(f"phase 8a: replica {r} losses {losses}")
        if counts["cs_adam_tiled"] != 2 * X_STEPS \
                or counts["cs_update"] != 2 * X_STEPS \
                or counts["bucket_csr"] != 2 * X_STEPS:
            raise AssertionError(f"the extreme step did not launch B1, its "
                                 f"CSR and the dedup sum (B5) once a table "
                                 f"a step: {counts}")
        if not last < first:
            raise AssertionError(f"replica {r}: the loss did not fall")
        if not all(torch.isfinite(t).all() for t in tables_of(params)):
            raise AssertionError(f"replica {r}: non-finite table")
        if r == 0:
            final, losses0, state0 = [t.clone() for t in tables_of(params)], \
                losses, state
        else:
            more = extreme_batches(cfg, maps[r], X_BATCH, 5, dev,
                                   first=X_STEPS)
            profile_steps("phase 8a", lambda: run_extreme(
                step_fn, params, state, more), statistics.median(ms[1:]),
                by_name=True)
        del params, state
    phase_extreme_witness(cfg, dev, start, batches0, final, losses0)
    phase_extreme_repeat(cfg, dev, start, batches0, final, losses0, state0)
    states = phase_extreme_arms(cfg, dev, start, batches0)
    peak = torch.cuda.max_memory_allocated()    # 8e resets the counter
    phase_extreme_memory(cfg, dev, maps[0], seed)
    phase_extreme_sites(cfg, dev, params_from(final), batches0[0])
    return counts_8a, {"cs_rmsprop": state0, **states}, params_from(final), \
        batches0[-1], peak


def phase_extreme_witness(cfg, dev, start, batches, final, losses):
    """8b: replica 0's batches from the same start through backend
    ``xla``: losses and both tables within rtol 1e-4, atol 1e-5 of 8a."""
    import torch
    step_fn, _opts, state = extreme_step(cfg, dev, optimizer="cs_rmsprop",
                                         backend="xla")
    reset_counts()
    params, _, x_losses, ms = run_extreme(step_fn, params_from(start), state,
                                          batches)
    counts = read_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, x_losses))
    errs_ = [float((a - b).abs().max())
             for a, b in zip(tables_of(params), final)]
    bit = x_losses == losses and all(
        torch.equal(a, b) for a, b in zip(tables_of(params), final))
    log(f"phase 8b: backend xla, replica 0's {len(batches)} batches: ms/step "
        f"median {statistics.median(ms[1:])}; launches {counts}; loss max rel "
        f"diff vs tiled {rel}, tables max_abs_err {errs_}; losses and tables "
        f"equal to the bit {bit}")
    if counts["cs_adam_tiled"]:
        raise AssertionError("the xla witness launched B1")
    torch.testing.assert_close(torch.tensor(x_losses), torch.tensor(losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    for a, b in zip(tables_of(params), final):
        torch.testing.assert_close(a, b, **WITNESS_TOL)


def phase_extreme_repeat(cfg, dev, start, batches, final, losses, state):
    """8c: 8a's replica-0 run again from the same start: both tables, V
    and the losses to the bit; then one step under sync-debug 'error'
    with its batch already on the card."""
    import torch
    step_fn, _opts, fresh = extreme_step(cfg, dev, optimizer="cs_rmsprop")
    params, state2, losses2, _ = run_extreme(step_fn, params_from(start),
                                             fresh, batches)
    same = {"tables": all(torch.equal(a, b)
                          for a, b in zip(tables_of(params), final)),
            "v": all(torch.equal(state[p]["v"], state2[p]["v"])
                     for p in state),
            "losses": losses2 == losses}
    log(f"phase 8c: replica 0's {len(batches)} steps again from the same "
        f"start: equal to the bit {same}")
    if not all(same.values()):
        raise AssertionError(f"two runs of the extreme step differ: {same}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn(params, state2, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 8c: one extreme step under torch.cuda.set_sync_debug_mode("
        "'error'): no host-device synchronisation")


def phase_extreme_arms(cfg, dev, start, batches) -> dict:
    """8d: ``cs_adam`` (B1 with M) and ``dense_adam`` on replica 0's
    batches from 8a's start; the loss must fall; each arm's
    ``state_bytes``.  Returns ``{"cs_adam": its state}``."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    out = {}
    for optimizer in ("cs_rmsprop", "cs_adam", "dense_adam"):
        step_fn, opts, state = extreme_step(cfg, dev, optimizer=optimizer)
        nbytes = state_bytes(state)
        if optimizer == "cs_rmsprop":
            log(f"phase 8d: cs_rmsprop state_bytes {nbytes} (8a's arm)")
            continue
        reset_counts()
        params, state, losses, ms = run_extreme(step_fn, params_from(start),
                                                state, batches)
        counts = read_counts()
        first, last = loss_windows(losses)
        log(f"phase 8d: {optimizer} {len(batches)} steps: ms/step median "
            f"{statistics.median(ms[1:])}; loss {losses[0]} -> {losses[-1]}, "
            f"window means {first} -> {last}; state_bytes {nbytes}; launches "
            f"{counts}")
        want_b1 = 2 * len(batches) if optimizer == "cs_adam" else 0
        if counts["cs_adam_tiled"] != want_b1:
            raise AssertionError(f"{optimizer}: B1 launched "
                                 f"{counts['cs_adam_tiled']} times")
        if not last < first:
            raise AssertionError(f"{optimizer}: the loss did not fall")
        if not all(torch.isfinite(t).all() for t in tables_of(params)):
            raise AssertionError(f"{optimizer}: non-finite table")
        if optimizer == "cs_adam":
            out[optimizer] = state
        del params, state
    return out


def phase_extreme_memory(cfg, dev, cmap, seed: int) -> None:
    """8e: the peak device memory of a step of ``dense_adam`` and of
    ``cs_rmsprop`` at batch 1,024 and 8,192: the arm's tables, state and
    the step's transients, above what the card held before the arm was
    built (Tab. 8's memory story on this card)."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    from repro_torch.train.extreme import make_extreme_step
    for optimizer in ("dense_adam", "cs_rmsprop"):
        for batch in (X_BATCH, X_BIG_BATCH):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            init_fn, step_fn, opts = make_extreme_step(
                cfg, optimizer=optimizer, lr=X_LR, device=dev)
            params = init_fn(torch.Generator(device=dev).manual_seed(seed))
            state = {p: o.init() for p, o in opts.items()}
            batches = extreme_batches(cfg, cmap, batch, 2, dev)
            params, state, m = step_fn(params, state, batches[0])
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            params, state, m = step_fn(params, state, batches[1])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"phase 8e: {optimizer} batch {batch}: peak device memory "
                f"of a step {peak} B above the card's {base} B before the "
                f"arm; resident after a step {resident} B (params "
                f"{state_bytes(params)} B, optimizer state "
                f"{state_bytes(state)} B); loss {float(m['loss'])}")
            del params, state, batches, m
    torch.cuda.empty_cache()


def phase_extreme_sites(cfg, dev, params, batch) -> None:
    """8f, C1's last sites at the extreme step's shapes: each gives the
    same bits twice on the card and the bits of a CPU copy.  The ordered
    table add of both tables' raw (ids, rows) gradients (every occurrence
    carries a row, as under ``stream``/``ref``), and the ``tiled``
    updates through it equal to one ``index_add_``; the dense path's
    plain routes (``ema_update_read_xla`` f32 and bf16,
    ``ema_update_read_ref`` bf16, int8 cells) over the class head's
    gradient into its (3, 7,168, 64) sketch; a 1-D ``DenseStore``."""
    import torch
    from repro_torch.core import sketch as cs
    from repro_torch.core.optimizers import (SketchHParams,
                                             apply_sparse_updates)
    from repro_torch.core.quantize import QuantState
    from repro_torch.core.stores import DenseStore
    from repro_torch.kernels import ops
    from repro_torch.train.extreme import extreme_grads
    _loss, grads = extreme_grads(params, batch)
    host_params = {k: {"table": v["table"].cpu()} for k, v in params.items()}

    def bits(xs):
        return [x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                for x in xs]

    def check(name, run):
        before = read_counts()["cs_update"]
        a, b = run(dev), run(dev)
        used = read_counts()["cs_update"] - before
        h = run(torch.device("cpu"))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))
        cpu = all(torch.equal(x.cpu(), y) for x, y in zip(bits(a), bits(h)))
        log(f"phase 8f: {name}: two runs equal to the bit {same}, equal to a "
            f"CPU copy {cpu} ({used} B5 launches)")
        if not (same and cpu and used):
            raise AssertionError(f"{name}: same {same}, cpu {cpu}, B5 {used}")

    for path, g in grads.items():
        top = path.split("/")[0]

        def ordered(d, top=top, g=g):
            table = (params if d.type == "cuda" else host_params)[top]["table"]
            return [apply_sparse_updates(table.clone(), {
                "ids": g["ids"].to(d), "rows": g["rows"].to(d)})]
        check(f"apply_sparse_updates {path} ({g['ids'].numel()} "
              f"occurrences, {int(g['ids'].unique().numel())} ids)", ordered)
    step_fn, opts, state = extreme_step(cfg, dev, optimizer="cs_rmsprop")
    cost = {}
    for path, opt in opts.items():
        upd, _ = opt.update(grads[path], state[path])
        table = params[path.split("/")[0]]["table"]
        a = apply_sparse_updates(table.clone(), upd)
        b = apply_sparse_updates(table.clone(), upd, first_only=True)
        if not torch.equal(a, b):
            raise AssertionError(f"{path}: tiled updates through the ordered "
                                 f"add differ from one index_add_")
        cost[path] = [cuda_ms(lambda f=f: apply_sparse_updates(
            a, upd, first_only=f), reps=20, warmup=2) for f in (False, True)]
    log(f"phase 8f: tiled updates of both tables: the ordered add equal to "
        f"the bit to one index_add_ (later occurrences carry zeros); ms a "
        f"call [ordered, one index_add_] {json.dumps(cost)}")
    g = grads["class_head/table"]
    for name, dtype, fn in (("ema_update_read_xla f32", "float32",
                             ops.ema_update_read_xla),
                            ("ema_update_read_xla bf16", "bfloat16",
                             ops.ema_update_read_xla),
                            ("ema_update_read_ref bf16", "bfloat16",
                             ops.ema_update_read_ref),
                            ("ema_update_read_xla int8", "int8",
                             ops.ema_update_read_xla)):
        spec = SketchHParams(compression=100.0, dtype=dtype).spec(
            "class_head/table", (cfg.n_meta, cfg.dim), signed=True)

        def route(d, spec=spec, fn=fn):
            ids, rows = g["ids"].to(d), g["rows"].to(d)
            S = cs.update(spec, cs.init(spec, d), ids, rows * 3.0, sr_seed=5)
            S, est = fn(spec, S, ids, rows, beta=0.999, scale=1.0 - 0.999,
                        sr_seed=9)
            return (list(S) if isinstance(S, QuantState) else [S]) + [est]
        check(f"{name} into {spec.shape}", route)
    store = DenseStore().bind("s", (cfg.n_meta,), torch.float32)

    def dense_1d(d):
        return [store.accumulate(store.init(d) + 1.0, g["rows"][:, 0].to(d),
                                 g["ids"].to(d), scale=0.5)]
    check(f"DenseStore.accumulate 1-D ({cfg.n_meta},)", dense_1d)


def time_b1_extreme(dev, states, params, batch) -> list:
    """Phase 5 at the extreme step's shapes (8f for B1): B1 as the step
    calls it on both tables, without M (8a's ``cs_rmsprop`` state) and
    with M (8d's ``cs_adam`` state), on the last batch's gradient: held
    to the plain version on the card (M and V within atol 2e-5, upd
    bit-equal at each first position) and to a CPU copy (M and V
    bit-equal, upd within rtol 1e-6); its time beside its byte bound."""
    import torch
    from repro_torch.kernels import dedup as dd, ops
    from repro_torch.kernels.cs_adam_tiled import (at_positions,
                                                   cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.extreme import extreme_grads
    _loss, grads = extreme_grads(params, batch)
    eta, bc1, bc2 = ops._adam_hypers(X_STEPS, -1.0, 0.9, 0.999)
    hp = SketchHParams(compression=100.0)
    rows_out = []
    for optimizer, track in (("cs_rmsprop", False), ("cs_adam", True)):
        for path, g in grads.items():
            shape = tuple(params[path.split("/")[0]]["table"].shape)
            spec_m = hp.spec(path, shape, signed=True) if track else None
            spec_v = hp.spec(path, shape, signed=False)
            st = states[optimizer][path]
            kw = dict(lr=eta, b1=0.9 if track else 0.0, b2=0.999, eps=1e-8,
                      bc1=bc1, bc2=bc2)
            batch_u = dd.dedup_rows(g["ids"], g["rows"])
            bm, sm, bv = ops._adam_addressing(spec_m, spec_v,
                                              batch_u.unique_ids)
            args = (st["m"], st["v"], bm, sm, bv, batch_u.rows)
            pos = (batch_u.inv, batch_u.first_pos)
            b1kw = dict(n_valid=batch_u.n_unique, positions=pos, **kw)
            want = cs_adam_tiled_plain(*clone(args),
                                       n_valid=batch_u.n_unique, **kw)
            got = cs_adam_tiled(*clone(args), **b1kw)
            err = max_err([w for w in want[:2] if w is not None],
                          [c for c in got[:2] if c is not None])
            upd_bit = torch.equal(at_positions(want[2], batch_u.first_pos),
                                  got[2])
            host = cs_adam_tiled(*on_cpu(args),
                                 n_valid=batch_u.n_unique.cpu(),
                                 positions=on_cpu(pos), **kw)
            line = b1_vs_cpu(host, got)
            if not (upd_bit and err <= COLLISION_ATOL):
                raise AssertionError(f"B1 at {path} {optimizer}: upd "
                                     f"bit-equal {upd_bit}, M/V err {err}")
            scratch = clone(args)
            ms = cuda_ms(lambda: cs_adam_tiled(*scratch, **b1kw), reps=20,
                         warmup=3)
            parts = {name[:60]: t / 5 for t, _c, name in kernel_profile(
                lambda: [cs_adam_tiled(*scratch, **b1kw) for _ in range(5)]
                + [torch.cuda.synchronize()])[2]}
            plain_ms = cuda_ms(lambda: cs_adam_tiled_plain(
                *scratch, n_valid=batch_u.n_unique, **kw), reps=5)
            k, k_u, d = g["ids"].numel(), int(batch_u.n_unique), shape[1]
            depth = spec_v.depth
            rows_m = unique_rows(bm, k_u, spec_m.width) if track else 0
            rows_v = unique_rows(bv, k_u, spec_v.width)
            nbytes = b1_bytes(d, k, k_u, rows_m, rows_v, depth, track)
            row = dict(table=path, optimizer=optimizer, width=spec_v.width,
                       d=d, k=k, k_unique=k_u, touched_rows_m=rows_m,
                       touched_rows_v=rows_v, bytes=nbytes, ms=ms,
                       plain_ms=plain_ms, max_abs_err=err,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       device_ms_by_kernel=parts)
            rows_out.append(row)
            log(f"phase 8f: B1 at {path} ({optimizer}, sketches "
                f"{spec_v.shape}) k_u={k_u} (of {k}): {line}; M/V "
                f"max_abs_err {err} vs the plain version on the card, upd "
                f"bit-equal to it")
            log(f"phase 5 (extreme): B1 {path} {optimizer} d={d} width "
                f"{spec_v.width}: {ms} ms, plain {plain_ms} ms, bound "
                f"{row['bound_ms']} ms ({nbytes} B at 3.35 TB/s; touched "
                f"rows M {rows_m} V {rows_v}); device ms a call by kernel "
                f"{json.dumps(parts)}")
            del scratch, want, got, host
    return rows_out


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
    phases = [
        ("2", lambda: (phase_kernels(dev, args.seed),
                       phase_full_width_b1_b4(dev, args.seed),
                       phase_csr_and_hazards(dev, args.seed),
                       phase_sketch_kernels(dev, args.seed),
                       phase_bf16_kernel(dev, args.seed))),
        ("3", lambda: phase_main(dev, args.seed)),
        ("4", lambda: phase_serve_and_stream(dev, *out["3"][:2], args.seed)),
        ("4 (sketch ops)", lambda: phase_sketch_ops(dev, out["3"][3],
                                                    args.seed)),
        ("5", lambda: phase_times(dev, *out["3"][:4], args.seed,
                                  out["4 (sketch ops)"])),
        ("6", lambda: phase_dense(dev, args.seed)),
        ("7", lambda: phase_dense_bf16(dev, out["6"])),
        ("7b", lambda: phase_dense_int8(dev, out["6"][1])),
        ("7c", lambda: phase_sparse_bf16(dev, args.seed, out["3"][5])),
        ("7d", lambda: phase_async_clean(dev, out["6"][1])),
        ("8", lambda: phase_extreme(dev, args.seed)),
        ("5 (extreme)", lambda: time_b1_extreme(dev, *out["8"][1:4])),
    ]
    out, peak = {}, 0
    for name, run in phases:
        t0 = time.perf_counter()
        out[name] = run()
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"phase {name}: wall {time.perf_counter() - t0:.1f} s")
    kernels = out["5"]
    extreme = out["8"][0]       # 8a's cs_rmsprop runs, both replicas
    launches = {"cs_adam_tiled": (out["3"][4]["cs_adam_tiled"]
                                  + extreme["cs_adam_tiled"]),
                "cs_adam_fused": out["4"]["cs_adam_fused"],
                "cs_ema_tiled": out["6"][0]["cs_ema_tiled"],
                "cs_ema_tiled_bf16": out["7"]["cs_ema_tiled_bf16"],
                # the main and extreme paths' dedup sums, and the sketch
                # ops' update
                "cs_update": (out["3"][4]["cs_update"]
                              + extreme["cs_update"]
                              + out["4 (sketch ops)"][4]["cs_update"]),
                # B1's CSR on the main and extreme paths, prev for B2,
                # B5's CSR in the sketch ops, and B3's cached dense-row CSR
                "bucket_csr": (out["3"][4]["bucket_csr"]
                               + extreme["bucket_csr"]
                               + out["4"]["bucket_csr"]
                               + out["4 (sketch ops)"][4]["bucket_csr"]
                               + out["6"][0]["bucket_csr"])}
    for row in kernels:
        row.setdefault("launches", launches.get(row["name"]))
        if row["name"] == "cs_adam_tiled":
            row["at_extreme_shapes"] = out["5 (extreme)"]
            row["launches_extreme_path"] = extreme["cs_adam_tiled"]
    log(f"peak device memory of the whole run {max(peak, out['8'][4])} B")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
