"""Dry run: trace every (arch x shape) cell on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun        # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b \
        --shape train_4k [--mesh 16x16] [--aux-budget config]

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder TPU devices.  Here each cell's production step
(the train step with the count-sketch optimizer, or the serve prefill or
decode step) runs once on ``meta`` tensors under ``op_cost.OpCost``: no
data, no allocation, no card.  The step's kernels pick their plain
versions on ``meta``, the device the run asked for.  A record goes to
``build/dryrun/<mesh>/<arch>__<shape>.json`` with the reference's keys:

  * ``devices``: the grid ``DxM``'s size (``--mesh``, default ``1x1``,
    one card); the per-device FLOPs and bytes are the global counts
    divided by it;
  * ``roofline``: ``analysis.Roofline`` on the H100's data-sheet peaks;
    the collectives are the gradient ``pmean``s of a train step over a
    stand-in 'data' axis of size D (``op_cost.StandInAxis``); the port
    has no tensor parallelism, so the reference's 'model'-axis
    collectives have no counterpart and count 0;
  * ``memory``: the per-device argument bytes (params, optimizer state,
    batch or cache), each leaf's block under the spec trees of
    ``TrainStep.shardings``/``ServeStep.param_shardings``; the peak only a
    run on a card measures, so it is null;
  * ``opt_sharding``: the coverage of the optimizer state's spec tree
    (``opt_sharding_summary``);
  * ``lower_s``: the trace's seconds; ``compile_s`` 0 (nothing
    compiles).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, cell_skip
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis
from repro_torch.launch.op_cost import OpCost, StandInAxis
from repro_torch.models.config import ArchConfig, ShapeConfig

REPO = pathlib.Path(__file__).resolve().parents[3]
OUT_ROOT = REPO / "build" / "dryrun"
# the reference's committed records, read (never written) for the bytes
# ratio; its "single" mesh is a 16 x 16 grid
REFERENCE_ROOT = REPO / "experiments" / "dryrun"
REFERENCE_MESHES = {"16x16": "single"}

# Optimizer exercised by the dry-run train cells: the paper's headline
# configuration (CS-MV Adam: both moments sketched on embedding+softmax).
TRAIN_OPTIMIZER = "cs_adam"


def parse_mesh(mesh: str) -> Tuple[int, int]:
    """``'DxM'`` -> (D, M)."""
    m = re.fullmatch(r"(\d+)x(\d+)", mesh)
    if m is None or min(int(m.group(1)), int(m.group(2))) < 1:
        raise ValueError(f"--mesh is a grid DxM such as 1x1 or 16x16, "
                         f"not {mesh!r}")
    return int(m.group(1)), int(m.group(2))


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)


def opt_sharding_summary(opt_shape, ospec, mesh) -> dict:
    """Coverage stats of the optimizer-state spec tree: how many tensor
    leaves resolved to a sharded (non-replicated) spec, split into
    sketch-shaped leaves and the rest, as the reference records them, so
    a state-layout change that silently un-shards sketch state shows up
    as a diff."""
    out = {"leaves": 0, "sharded": 0, "sketch_leaves": 0,
           "sketch_sharded": 0}
    specs = shd.Placement(ospec, mesh).spec_leaves(opt_shape)
    for (_path, leaf), spec in zip(shd._flatten(opt_shape), specs):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            continue
        out["leaves"] += 1
        sharded = bool(tuple(spec or ()))
        out["sharded"] += sharded
        if leaf.dim() == 3 and leaf.shape[0] <= 8:
            out["sketch_leaves"] += 1
            out["sketch_sharded"] += sharded
    return out


def block_nbytes(tree, specs, mesh) -> int:
    """The bytes one replica holds of ``tree``: each tensor leaf's block
    under its spec (``sharding.local_block``; on ``meta`` nothing is
    allocated)."""
    total = 0
    for (_path, leaf), spec in zip(shd._flatten(tree),
                                   shd.Placement(specs, mesh)
                                   .spec_leaves(tree)):
        if not isinstance(leaf, torch.Tensor):
            continue
        if spec and leaf.dim():
            leaf = shd.local_block(leaf.to("meta"), spec, mesh,
                                   (0,) * len(mesh.axis_names))
        total += leaf.nbytes
    return total


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: str = "1x1", *,
               optimizer: str = TRAIN_OPTIMIZER, plan=None,
               store_backend: str = "", sources: bool = False):
    """Run one cell's step once on ``meta`` under ``OpCost``.  Returns
    ``(cost, params_shape, tokens, kind, info)``; ``info`` holds the
    per-device ``argument_bytes`` and, for a train cell, the
    ``opt_sharding`` coverage.  ``plan``: a ``repro_torch.plan.Plan``
    replacing the regex policy of a train cell (serve cells carry no
    optimizer state); ``store_backend``: the kernel backend of the
    sketch paths (their plain versions on ``meta``)."""
    D, M = parse_mesh(mesh)
    grid = shd.Grid((D, M))
    cost = OpCost(sources=sources)
    if shape.kind == "train":
        from repro_torch.train.steps import make_train_step
        sampled = optimizer.endswith("+sampled")
        opt_name = optimizer.replace("+sampled", "")
        if store_backend and plan is not None:
            plan = plan.with_backend(store_backend)
        ts = make_train_step(cfg, optimizer=opt_name,
                             sampled_softmax=sampled, plan=plan,
                             kernel_backend=store_backend or None,
                             dp_axis=StandInAxis(D, cost) if D > 1 else None,
                             device="meta")
        ps = ts.params_shape()
        os_ = ts.opt_shape(ps)
        batch = configs.train_batch_specs(cfg, shape,
                                          sampled_softmax=sampled)
        pspec, ospec, bspec, _ = ts.shardings(grid, batch)
        info = {"opt_sharding": opt_sharding_summary(os_, ospec, grid),
                "argument_bytes": block_nbytes(ps, pspec, grid)
                + block_nbytes(os_, ospec, grid)
                + block_nbytes(batch, bspec, grid)}
        with cost:
            ts.step_fn(ps, os_, batch)
        return cost, ps, shape.global_batch * shape.seq_len, "train", info

    from repro_torch.serve.steps import make_serve_step
    ss = make_serve_step(cfg, batch=shape.global_batch, max_seq=shape.seq_len)
    ps = ss.params_shape()
    pspec = ss.param_shardings(grid)
    cspec = ss.cache_specs(grid)
    if shape.kind == "prefill":
        batch = configs.prefill_batch_specs(cfg, shape)
        bspec = {k: shd.batch_spec(grid, tuple(v.shape))
                 for k, v in batch.items()}
        info = {"argument_bytes": block_nbytes(ps, pspec, grid)
                + block_nbytes(batch, bspec, grid)}
        with cost:
            ss.prefill_fn(ps, batch)
        return (cost, ps, shape.global_batch * shape.seq_len, "prefill",
                info)
    # decode: one token against a seq_len cache
    cache = ss.cache_shape()
    token = configs.decode_batch_specs(cfg, shape)["token"]
    info = {"argument_bytes": block_nbytes(ps, pspec, grid)
            + block_nbytes(cache, cspec, grid)
            + block_nbytes(token, shd.batch_spec(grid, tuple(token.shape)),
                           grid)}
    with cost:
        ss.decode_fn(ps, cache, token)
    return cost, ps, shape.global_batch, "decode", info


def roofline(cfg: ArchConfig, cost: OpCost, params_shape, tokens: int,
             kind: str, devices: int) -> analysis.Roofline:
    """The cell's roofline terms a device from its global counts."""
    mf = analysis.model_flops(cfg, params_shape, tokens,
                              "train" if kind == "train" else "serve")
    return analysis.Roofline(
        flops=cost.flops / devices, bytes_accessed=cost.bytes / devices,
        collective_link_bytes=cost.collective_link_bytes,
        collectives=cost.collectives, model_flops_per_device=mf / devices)


def plan_cell(cfg: ArchConfig, budget: str, *, optimizer: str):
    """Solve and print the memory plan a train cell will execute: the
    plan table and per-leaf predicted error, before anything runs."""
    from repro_torch.plan import plan_for_config
    opt_name = optimizer.replace("+sampled", "")
    plan = plan_for_config(cfg, budget, optimizer=opt_name)
    print(f"[plan] {cfg.name} aux-budget={budget} "
          f"({plan.budget_bytes:,} B)", flush=True)
    print(plan.table(), flush=True)
    return plan


def reference_record(arch: str, shape_name: str, mesh: str,
                     root: pathlib.Path = REFERENCE_ROOT) -> Optional[dict]:
    """The reference's committed record of the same cell and grid, if
    any."""
    name = REFERENCE_MESHES.get(mesh)
    path = root / name / f"{arch}__{shape_name}.json" if name else None
    if path is None or not path.exists():
        return None
    return json.loads(path.read_text())


def run_cell(arch: str, shape_name: str, mesh: str = "1x1", *,
             force: bool = False, optimizer: str = TRAIN_OPTIMIZER,
             out_root: pathlib.Path = OUT_ROOT, tag: str = "",
             aux_budget: str = "", store_backend: str = "") -> dict:
    D, M = parse_mesh(mesh)
    out_dir = pathlib.Path(out_root) / mesh
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = SHAPES[shape_name]
    suffix = f"__{tag}" if tag else ""
    if aux_budget and shape.kind == "train":
        # a budgeted train record has its own cache key: a planned sweep
        # never returns an unplanned record (or another budget's)
        token = re.sub(r"[^A-Za-z0-9.]+", "-", aux_budget)
        suffix += f"__plan-{token}"
    if store_backend and shape.kind == "train":
        suffix += f"__be-{re.sub(r'[^A-Za-z0-9.]+', '-', store_backend)}"
    out_path = out_dir / f"{arch}__{shape_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    skip = cell_skip(arch, shape_name)
    if skip:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "status": "skipped", "reason": skip}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    cfg = configs.get(arch)
    n_dev = D * M
    plan = None
    t0 = time.time()
    try:
        # inside the try: an infeasible budget is recorded as this cell's
        # error and the sweep continues
        if aux_budget and shape.kind == "train":
            plan = plan_cell(cfg, aux_budget, optimizer=optimizer)
        cost, ps, tokens, kind, info = trace_cell(
            cfg, shape, mesh, optimizer=optimizer, plan=plan,
            store_backend=store_backend)
        t_trace = time.time() - t0
        roof = roofline(cfg, cost, ps, tokens, kind, n_dev)
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh,
            "status": "ok", "kind": kind, "devices": n_dev,
            "optimizer": optimizer if kind == "train" else None,
            "store_backend": (store_backend or None) if kind == "train"
                             else None,
            "tokens_global": tokens,
            "n_params": analysis.count_params(ps),
            "n_params_active": analysis.active_params(cfg, ps),
            "lower_s": round(t_trace, 1), "compile_s": 0.0,
            "memory": analysis.memory_dict(info.pop("argument_bytes")),
            "roofline": roof.to_dict(),
            **info,
        }
        if plan is not None:
            rec["plan"] = {"aux_budget": aux_budget,
                           "budget_bytes": plan.budget_bytes,
                           "predicted_aux_bytes": plan.predicted_aux_bytes,
                           "modes": plan.n_by_mode(),
                           "store_tree": plan.store_tree().to_json()}
    except Exception as e:  # noqa: BLE001 - recorded, the sweep continues
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(_jsonable(rec), indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="1x1",
                    help="the grid DxM of cards ('data' x 'model')")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimizer", default=TRAIN_OPTIMIZER)
    ap.add_argument("--tag", default="", help="suffix for perf-iteration runs")
    ap.add_argument("--aux-budget", default="",
                    help="aux-memory budget for train cells: bytes | "
                         "'8.6GB' | '0.85x' of dense | 'floor' | 'config' "
                         "(the arch's aux_budget_bytes); prints the plan "
                         "table before the trace")
    ap.add_argument("--store-backend", default="",
                    help="kernel backend for the sketch paths of train "
                         "cells ('ref' | 'xla' | 'tiled' | 'auto'); their "
                         "plain versions on meta")
    ap.add_argument("--out", default=str(OUT_ROOT),
                    help="root directory of the records")
    args = ap.parse_args(argv)
    parse_mesh(args.mesh)

    archs = [args.arch] if args.arch else list(configs.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            rec = run_cell(arch, shape_name, args.mesh, force=args.force,
                           optimizer=args.optimizer, tag=args.tag,
                           out_root=pathlib.Path(args.out),
                           aux_budget=args.aux_budget,
                           store_backend=args.store_backend)
            st = rec["status"]
            head = f"[{args.mesh:6s}] {arch:26s} {shape_name:12s}"
            if st == "ok":
                r = rec["roofline"]
                ref = reference_record(arch, shape_name, args.mesh)
                ratio = ("" if ref is None or ref.get("status") != "ok" else
                         f" bytes/ref={r['bytes_per_device'] / ref['roofline']['bytes_per_device']:.3f}")
                print(f"{head} OK  dom={r['dominant']:10s} "
                      f"c/m/n={r['compute_s']:.3e}/{r['memory_s']:.3e}/"
                      f"{r['collective_s']:.3e}s "
                      f"mfu<={r['mfu_bound']:.2f} args="
                      f"{rec['memory']['argument_size_in_bytes'] / 2**30:.2f}"
                      f"GiB (trace {rec['lower_s']}s){ratio}", flush=True)
            elif st == "skipped":
                print(f"{head} SKIP ({rec['reason'][:60]})", flush=True)
            else:
                failures += 1
                print(f"{head} ERROR {rec['error'][:200]}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
