#!/usr/bin/env python3
"""The sparse_embedding launcher's per-step losses over learning rates and
seeds, at qwen2-0.5b's full table, on one card.

    python3 tools/sparse_lr_scan.py [--lrs 1e-5,3e-5,1e-3] [--seeds 0,1]

Runs ``repro_torch.launch.train.main`` in this process for each (lr,
seed): ``--workload sparse_embedding`` on the 151,936 x 896 table with
compression 5 (width 10,240), 8 x 2,048 ids a step, 20 steps, no
checkpoint.  For each run it prints one JSON line: the launcher's exit
code, the means and medians of the first and last 10 per-step losses,
the steps whose loss passes the lowest before them by more than 10%,
and the losses.  ``--device cpu --rows --dim`` run it small on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run(args, lr: str, seed: str) -> dict:
    from repro_torch.launch import train
    base, losses = train.Trainer, []

    class Kept(base):
        def fit(self, state):
            try:
                return super().fit(state)
            finally:
                losses.extend(h["loss"] for h in self.history)

    argv = ["--workload", "sparse_embedding", "--sparse-rows",
            str(args.rows), "--sparse-dim", str(args.dim),
            "--sparse-compression", "5", "--batch", "8", "--seq", "2048",
            "--lr", lr, "--seed", seed, "--steps", str(args.steps),
            "--device", args.device]
    train.Trainer = Kept
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train.main(argv)
    finally:
        train.Trainer = base
    h = len(losses) // 2
    return {"lr": float(lr), "seed": int(seed), "rc": rc,
            "mean": [float(np.mean(losses[:h])), float(np.mean(losses[h:]))],
            "median": [float(np.median(losses[:h])),
                       float(np.median(losses[h:]))],
            "spiked_steps": [i for i, l in enumerate(losses)
                             if i and l > 1.1 * min(losses[:i])],
            "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="1e-5,2e-5,3e-5,5e-5,1e-4,2e-4,3e-4,"
                                      "5e-4,1e-3")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--rows", type=int, default=151_936)
    ap.add_argument("--dim", type=int, default=896)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("sparse_lr_scan: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps({"card": torch.cuda.get_device_name(0)}),
              flush=True)
    for lr in args.lrs.split(","):
        for seed in args.seeds.split(","):
            print(json.dumps(run(args, lr, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
