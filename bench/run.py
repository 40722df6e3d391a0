#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card of this machine and
prints, as the last line of standard output, one JSON object: ``correct``
(the program's first steps against the plain reference, each number
beside its limit under ``check``), ``attempted`` and ``failed`` (the
window's steps and those whose loss was not finite), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``.  It exits non-zero and prints no
result without a CUDA card, when the port cannot be imported, or when
JAX or the JAX package was loaded.  Kernels build into ``build/`` inside
the checkout; see ``bench/README.md``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of this run at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from harness import manifest
    spec = manifest.cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"bench: {args.workload} needs {spec.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails where the port is absent)
    from harness.runner import run_cell
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = loaded_forbidden()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
