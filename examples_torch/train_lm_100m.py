"""End to end: train a ~100M-parameter LM with the count-sketch
optimizer and compare its optimizer-state footprint against dense Adam.

    PYTHONPATH=src python examples_torch/train_lm_100m.py --steps 200
    PYTHONPATH=src python examples_torch/train_lm_100m.py --small \
        --device cpu

The PyTorch counterpart of ``examples/train_lm_100m.py``, on the card
unless ``--device cpu``.  The default config is about 100 M params
(vocab 50k x d 512 embedding and softmax = 51 M, an 8-layer body of
about 50 M).  The sketch stores run on backend 'auto': on a card the
sketched tables' moments go through the hand-written ``cs_ema_tiled``
kernel.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import optimizers as O
from repro_torch.core.partition import SketchPolicy, leaf_paths
from repro_torch.core.stores import CountMinStore, CountSketchStore
from repro_torch.core.transforms import (chain, clip_by_global_norm,
                                         scale_by_adam, scale_by_lr,
                                         scale_by_rmsprop,
                                         tree_map_with_path)
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig


def build_cfg(small: bool) -> ArchConfig:
    if small:
        return ArchConfig(name="lm-7m", family="gqa", n_layers=2,
                          d_model=128, n_heads=4, n_kv=2, head_dim=32,
                          d_ff=512, vocab_size=8192, vocab_multiple=64,
                          attn_chunk=64, loss_chunk=64,
                          compute_dtype="float32")
    return ArchConfig(name="lm-100m", family="gqa", n_layers=8,
                      d_model=512, n_heads=8, n_kv=4, head_dim=64,
                      d_ff=2048, vocab_size=50_048, vocab_multiple=64,
                      attn_chunk=128, loss_chunk=128,
                      compute_dtype="float32")


def loss_and_grads(cfg, params, batch):
    """The loss and the gradient tree, through aliases of the params (the
    optimizer updates the params in place)."""
    live = tree_map_with_path(lambda _p, x: x.detach().requires_grad_(True),
                              params)
    leaves = leaf_paths(live)
    loss = tf.train_loss(cfg, live, batch, remat=False)
    grads = torch.autograd.grad(loss, [x for _p, x in leaves])
    by_path = {p: g for (p, _x), g in zip(leaves, grads)}
    return loss.detach(), tree_map_with_path(lambda p, _x: by_path[p],
                                             params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--optimizer", default="cs_adam",
                    choices=["cs_adam", "dense_adam", "cs_rmsprop"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    cfg = build_cfg(args.small)
    params = tf.init(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    n_params = sum(x.numel() for _p, x in leaf_paths(params))
    print(f"model: {cfg.name}  {n_params / 1e6:.1f}M params")

    # the composable store/transform API: the Adam rule, parameterized by
    # where its moments live, chained with the lr scale
    policy = SketchPolicy(min_rows=1024)
    m_store = CountSketchStore(compression=5.0, backend="auto")  # median
    v_store = CountMinStore(compression=5.0, backend="auto")     # min
    opt = {"cs_adam": chain(scale_by_adam(m_store=m_store, v_store=v_store,
                                          where=policy),
                            scale_by_lr(1e-3)),
           "cs_rmsprop": chain(scale_by_rmsprop(v_store=v_store,
                                                where=policy),
                               scale_by_lr(1e-3)),
           "dense_adam": O.adam(1e-3)}[args.optimizer]
    st = opt.init(params)
    dense_bytes = O.state_bytes(O.adam(1e-3).init(params))
    print(f"optimizer: {args.optimizer}  state "
          f"{O.state_bytes(st) / 2**20:.1f} MiB "
          f"(dense Adam: {dense_bytes / 2**20:.1f} MiB)")

    data = ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch, alpha=1.1))
    clip = clip_by_global_norm(1.0)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        b = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in data.batch(i).items()}
        loss, g = loss_and_grads(cfg, params, b)
        u, st = opt.update(clip(g), st, params)
        params = O.apply_updates(params, u)
        losses.append(float(loss))
        if (i + 1) % 20 == 0:
            dt = (time.perf_counter() - t0) / (i + 1)
            print(f"step {i + 1:4d}  loss {np.mean(losses[-20:]):.3f}  "
                  f"ppl {np.exp(np.mean(losses[-20:])):8.1f}  "
                  f"{dt:.2f}s/step", flush=True)
    print(f"\nfinal: loss {np.mean(losses[-20:]):.3f} "
          f"(from {np.mean(losses[:10]):.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
