"""Quickstart: the count-sketch optimizer as a drop-in (paper §4).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The PyTorch counterpart of ``examples/quickstart.py``, on the card
unless ``--device cpu``.  Shows: (1) the Count-Sketch Tensor's
UPDATE/QUERY on a power-law vector, (2) the composable store/transform
API, ``chain(clip, scale_by_adam(m_store=CountSketchStore(...),
v_store=CountMinStore(...)), scale_by_lr(...))``, next to the
``countsketch_adam`` wrapper, which is the same rule chain minus the
clip link, and (3) the memory each store choice frees.  The sketch
stores run on backend 'auto': on a card their fused update-and-read is
the hand-written ``cs_ema_tiled`` kernel.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import sketch as cs
from repro_torch.core.optimizers import (SketchHParams, adam, apply_updates,
                                         countsketch_adam, state_bytes)
from repro_torch.core.partition import SketchPolicy
from repro_torch.core.stores import (CountMinStore, CountSketchStore,
                                     Rank1Store)
from repro_torch.core.transforms import (chain, clip_by_global_norm,
                                         scale_by_adam, scale_by_lr)


def demo_sketch_tensor(dev):
    print("=== 1. Count-Sketch Tensor (paper Alg. 1) ===")
    n, d = 100_000, 64
    spec = cs.for_param((n, d), compression=20.0, depth=3)
    S = cs.init(spec, device=dev)
    print(f"table {n}x{d} ({n * d * 4 / 2**20:.1f} MiB) -> sketch "
          f"{spec.shape} ({spec.nbytes() / 2**20:.1f} MiB)")

    # power-law vector: a few heavy rows, long tail
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, n, size=4096), dtype=torch.int32,
                          device=dev)
    mags = rng.zipf(1.5, size=4096).clip(max=1000) / 10.0
    rows = torch.as_tensor(mags[:, None] * rng.randn(4096, d),
                           dtype=torch.float32, device=dev)
    S = cs.update(spec, S, ids, rows)

    hot = np.argsort(-mags)[:5]
    est = cs.query(spec, S, ids[torch.as_tensor(hot, device=dev)])
    for i, h in enumerate(hot):
        err = float(torch.linalg.norm(est[i] - rows[h])
                    / torch.linalg.norm(rows[h]))
        print(f"  heavy row |x|={mags[h]:7.1f}: rel err {err:.3f}")


def demo_composable_optimizer(dev):
    print("\n=== 2. Composable store/transform API (paper Alg. 4) ===")
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    params = {"tok_embed": {"table": normal(50_000, 64, scale=0.02)},
              "lm_head": {"table": normal(50_000, 64, scale=0.02)},
              "body": normal(64, 64, scale=1.0)}
    grads = {"tok_embed": {"table": normal(50_000, 64, scale=0.01)},
             "lm_head": {"table": normal(50_000, 64, scale=0.01)},
             "body": normal(64, 64, scale=0.01)}
    policy = SketchPolicy(min_rows=1024)        # embedding+softmax only

    # the update rule (Adam) composed with its moment STORES: 1st moment
    # in a signed Count-Sketch, 2nd in a Count-Min (the paper's CS-MV)
    # at 5x compression, clipped and lr-scaled, all one chain
    composed = chain(
        clip_by_global_norm(1.0),
        scale_by_adam(m_store=CountSketchStore(compression=5.0,
                                               backend="auto"),
                      v_store=CountMinStore(compression=5.0,
                                            backend="auto"),
                      where=policy),
        scale_by_lr(1e-3))

    # swapping a store swaps the memory/accuracy trade-off, the rule is
    # untouched: Rank1Store is the Adafactor-style LR-NMF-V baseline
    rank1 = chain(
        clip_by_global_norm(1.0),
        scale_by_adam(v_store=Rank1Store(), where=policy),
        scale_by_lr(1e-3))

    # the wrapper: the same adam+lr chain behind a policy bridge (no clip
    # link, so its trajectory differs from `composed` by the clipping;
    # its state memory is the same)
    legacy = countsketch_adam(1e-3, policy=policy,
                              hparams=SketchHParams(backend="auto"))

    for name, opt in [("dense Adam      ", adam(1e-3)),
                      ("CS-Adam (chain) ", composed),
                      ("rank-1 V (chain)", rank1),
                      ("CS-Adam (legacy)", legacy)]:
        p = {k: (v.clone() if isinstance(v, torch.Tensor)
                 else {kk: vv.clone() for kk, vv in v.items()})
             for k, v in params.items()}
        st = opt.init(p)
        for _ in range(3):
            updates, st = opt.update(grads, st, p)
            p = apply_updates(p, updates)
        mb = state_bytes(st) / 2**20
        print(f"  {name}: optimizer state {mb:7.2f} MiB")
    print("  (the paper's LM1B run saves 25% of total training memory"
          " this way)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    demo_sketch_tensor(dev)
    demo_composable_optimizer(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
