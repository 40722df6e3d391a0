#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1 2 3

For each seed it prints one JSON line with the numbers of
``harness.check`` for:

* ``control``: what has to come out not correct.  A ``sparse_rows`` cell
  runs the program with its own bfloat16 sketch cells (the precision
  below the float32 sketches the configuration states); an ``lm_train``
  cell puts the reference in the program's place with every product of
  its layers and head computed in float8 (e4m3 inputs, e5m2 gradients:
  the precision below the bfloat16 products the configuration states);
* ``half``: the fault "half of the batch left out, the mean taken over
  the rest", planted in the reference put in the program's place;
* ``sound``: the program's own first three steps, as a run of
  ``bench/run.py`` takes them, without the window.

Each against the float32 reference.  A step that returns its state
unchanged reads 1 on ``change_gap`` by the measure itself and needs no
run.  Needs a CUDA card, as ``bench/run.py`` does; the tests call
``readings`` on the CPU at small sizes.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(spec, seed: int, device) -> dict:
    import torch
    from harness import check, manifest
    kind = manifest.kind(spec.traffic)
    out = {"seed": seed}

    def gaps(prog, ref, tag):
        look = {}
        out[tag] = check.gaps(prog, ref, look, cell.sketched)
        out[tag + "_look"] = look
        out[tag + "_raw"] = prog

    def program(**kw):
        cell = kind.Cell(spec, seed, device, **kw)
        cell.build()
        prog = cell.check_steps()
        cell.free()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return cell, prog

    cell, prog = program()
    ref = cell.reference()
    out["reference_raw"] = ref
    gaps(prog, ref, "sound")
    if spec.traffic["kind"] == "sparse_rows":
        _cell, ctrl = program(cells="bfloat16")
    else:
        ctrl = cell.reference(precision="fp8")
    gaps(ctrl, ref, "control")
    gaps(cell.reference(half=True), ref, "half")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--arch", nargs="*", default=[], metavar="KEY=VALUE",
                    help="override configuration fields (a witness run, "
                         "such as compute_dtype=float32)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from harness import manifest
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = manifest.cell(args.workload, ROOT)
    for kv in args.arch:
        key, value = kv.split("=", 1)
        try:
            spec.config["arch"][key] = json.loads(value)
        except ValueError:
            spec.config["arch"][key] = value
    for seed in args.seeds:
        print(json.dumps(readings(spec, seed, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
