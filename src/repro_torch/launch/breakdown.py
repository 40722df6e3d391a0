"""Per-op cost breakdown of one dry-run cell: the heaviest rows.

    PYTHONPATH=src python -m repro_torch.launch.breakdown --arch zamba2_2_7b \
        --shape train_4k [--kind bytes|collective|flops|all] [--top 15]
    PYTHONPATH=src python -m repro_torch.launch.breakdown --arch qwen2_0_5b \
        --device cuda --batch 4 --store-backend auto

Counterpart of ``repro.launch.breakdown``, which ranks the HLO lines of
a compiled cell.  Here the cell's step runs once on ``meta`` under
``op_cost.OpCost(sources=True)``; each row is one (aten op, source): the
innermost ``obs.*`` scope and frame of this package, or the autograd
node of a backward pass.  ``--device cuda`` also runs the same step on
the card at ``--batch`` (a batch the card holds; ``--seq`` keeps the
cell's length unless given), once to build its kernels and once under
``torch.profiler`` with every counted op inside a ``record_function``
of its row, and prints each row's device time beside its counts, and
the device time of the work that is no aten op (the hand-written
kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import TRAIN_OPTIMIZER, trace_cell
from repro_torch.launch.op_cost import LABEL, OpCost

KINDS = ("bytes", "collective", "flops")


def collect_rows(cost: OpCost) -> Dict[str, List[tuple]]:
    """``{kind: [(total, per op, count, op, source, row index), ...]}``,
    heaviest first; collective rows count link bytes and have no
    index."""
    rows = {k: [] for k in KINDS}
    for r in cost.rows.values():
        if r.flops:
            rows["flops"].append((r.flops, r.flops / r.count, r.count, r.op,
                                  r.source, r.index))
        if r.bytes:
            rows["bytes"].append((r.bytes, r.bytes / r.count, r.count, r.op,
                                  r.source, r.index))
    for (kind, src), (n, _nbytes, link) in cost.collective_rows.items():
        rows["collective"].append((link, link / n, n, kind, src, None))
    for k in rows:
        rows[k].sort(key=lambda t: -t[0])
    return rows


def _device_ms(ev, total: bool) -> float:
    name = "device_time_total" if total else "self_device_time_total"
    us = getattr(ev, name, None)
    if us is None:
        us = getattr(ev, name.replace("device", "cuda"))
    return us / 1e3


def device_step(cfg, shape, batch: int, seq: Optional[int], device, *,
                optimizer: str, store_backend: str):
    """A thunk that runs the cell's step once on ``device`` at ``batch``
    x ``seq`` tokens, on random params from seed 0 and random tokens."""
    shape = dataclasses.replace(shape, global_batch=batch,
                                seq_len=seq or shape.seq_len)
    gen = torch.Generator(device=device).manual_seed(0)

    def real(spec):
        if spec.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab, tuple(spec.shape),
                                 generator=gen, device=device,
                                 dtype=spec.dtype)
        return torch.zeros(tuple(spec.shape), dtype=spec.dtype,
                           device=device)

    if shape.kind == "train":
        from repro_torch.train.steps import make_train_step
        ts = make_train_step(cfg, optimizer=optimizer,
                             kernel_backend=store_backend or None,
                             device=device)
        params = ts.init_fn(gen)
        state = [params, ts.optimizer.init(params)]
        b = {k: real(v) for k, v in
             configs.train_batch_specs(cfg, shape).items()}

        def step():
            state[0], state[1], _m = ts.step_fn(state[0], state[1], b)
        return step, shape

    from repro_torch.serve.steps import cache_factory, make_serve_step
    from repro_torch.train.steps import family_module
    ss = make_serve_step(cfg, batch=shape.global_batch, max_seq=shape.seq_len)
    params = family_module(cfg).init(gen, cfg, device=device)
    if shape.kind == "prefill":
        b = {k: real(v) for k, v in
             configs.prefill_batch_specs(cfg, shape).items()}
        return (lambda: ss.prefill_fn(params, b)), shape
    cache = cache_factory(cfg, device)(batch=shape.global_batch,
                                       max_seq=shape.seq_len)
    token = real(configs.decode_batch_specs(cfg, shape)["token"])
    return (lambda: ss.decode_fn(params, cache, token)), shape


def profile_rows(step) -> tuple:
    """``(cost, {row index: device ms}, device ms of the whole step,
    device ms outside every counted op)`` of one profiled run of
    ``step`` on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cost = OpCost(label=True)
    with torch.profiler.profile(activities=acts) as prof:
        with cost:
            step()
        torch.cuda.synchronize()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    per_row, total = {}, 0.0
    for ev in prof.key_averages():
        # a row's span on the host holds its op, whose kernels' device
        # time it totals; the span's own copy on the device is not work
        if ev.key.startswith(LABEL):
            if ev.device_type == cpu:
                per_row[int(ev.key[len(LABEL):])] = _device_ms(ev, True)
        elif ev.device_type == cuda and not getattr(
                ev, "is_user_annotation", False) \
                and not ev.key.startswith("obs."):
            total += _device_ms(ev, False)
    return cost, per_row, total, total - sum(per_row.values())


def print_rows(rows, kinds, top: int, device_ms=None) -> None:
    for k in kinds:
        unit = "FLOP" if k == "flops" else "B"
        total = sum(r[0] for r in rows[k])
        print(f"\n==== {k}: total {total / 1e12:.4f} T{unit} a step ====")
        for tot, per, n, op, src, idx in rows[k][:top]:
            # a reported kernel's row has no label, so no device ms
            ms = ("" if device_ms is None or idx is None
                  else f" {device_ms[idx]:10.4f} ms" if idx in device_ms
                  else f" {'-':>10} ms")
            print(f"{tot / 1e9:12.3f} G{unit} per={per / 1e6:12.3f} M{unit}"
                  f" x{n:6d}{ms} {op:22s} {src[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--kind", default="bytes",
                    choices=list(KINDS) + ["all"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--optimizer", default=TRAIN_OPTIMIZER)
    ap.add_argument("--store-backend", default="")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="cuda: also run the step on the card under "
                         "torch.profiler, at --batch")
    ap.add_argument("--batch", type=int, default=None,
                    help="the card's batch (default: the cell's)")
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    shape = SHAPES[args.shape]
    kinds = list(KINDS) if args.kind == "all" else [args.kind]
    cost = trace_cell(cfg, shape, args.mesh, optimizer=args.optimizer,
                      store_backend=args.store_backend, sources=True)[0]
    print(f"[breakdown] {args.arch} {args.shape} {args.mesh} on meta: "
          f"{cost.flops:.6e} FLOPs, {cost.bytes:.6e} bytes, "
          f"{cost.collective_link_bytes:.6e} collective link bytes")
    print_rows(collect_rows(cost), kinds, args.top)
    if args.device != "cuda":
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a card")
    step, run_shape = device_step(
        cfg, shape, args.batch or shape.global_batch, args.seq,
        torch.device("cuda"), optimizer=args.optimizer,
        store_backend=args.store_backend)
    step()                                  # builds the kernels
    torch.cuda.synchronize()
    cost, per_row, total, other = profile_rows(step)
    print(f"\n[breakdown] on {torch.cuda.get_device_name(0)} at batch "
          f"{run_shape.global_batch} x {run_shape.seq_len}: "
          f"{cost.flops:.6e} FLOPs, device {total:.3f} ms, of which "
          f"{other:.3f} ms outside the counted aten ops (the "
          f"hand-written kernels' among it)")
    print_rows(collect_rows(cost), [k for k in kinds if k != "collective"],
               args.top, per_row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
