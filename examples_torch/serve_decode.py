"""Serving example: prefill a batch of prompts, then batched greedy
decode against the cache: the ``serve_step`` of the ``decode_32k`` and
``long_500k`` dry-run cells, at a small size.

    PYTHONPATH=src python examples_torch/serve_decode.py --arch yi_9b
    PYTHONPATH=src python examples_torch/serve_decode.py --arch rwkv6_7b \
        --device cpu

The PyTorch counterpart of ``examples/serve_decode.py`` on the arch's
reduced config, on the card unless ``--device cpu``.  Any registry arch
runs; the enc-dec and VLM families get zero stub frames or patches.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.serve.steps import make_serve_step
from repro_torch.train.steps import family_module, stub_input


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi_9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    cfg = configs.get(args.arch).reduced()
    params = family_module(cfg).init(torch.Generator(device=dev)
                                     .manual_seed(0), cfg, device=dev)
    max_seq = args.prompt_len + args.new_tokens
    ss = make_serve_step(cfg, batch=args.batch, max_seq=max_seq)

    rng = np.random.RandomState(0)
    batch = {"tokens": torch.as_tensor(
        rng.randint(1, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    stub = stub_input(cfg)
    if stub is not None:
        batch[stub[0]] = torch.zeros((args.batch, stub[1], cfg.d_model),
                                     dtype=cfg.dtype, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = ss.prefill_fn(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, -1).to(torch.int32)

    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        logits, cache = ss.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        generated.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    toks_s = args.batch * (args.new_tokens - 1) / t_decode
    print(f"arch={cfg.name} batch={args.batch}")
    print(f"prefill {args.prompt_len} toks: {t_prefill * 1e3:.1f} ms "
          f"(the first call)")
    print(f"decode  {args.new_tokens - 1} steps: {t_decode * 1e3:.1f} ms "
          f"-> {toks_s:.1f} tok/s")
    print(f"sample continuation (seq 0): "
          f"{[int(g[0]) for g in generated[:10]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
