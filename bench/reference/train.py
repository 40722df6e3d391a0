"""The first steps of the two kinds of training a cell runs, in plain
float32 PyTorch, and the readings that ``harness.check`` compares:

* ``loss``: the loss of each step, before its update;
* ``state1``: the norm of every optimizer-state tensor after step 1 (the
  first gradient as the optimizer holds it), keyed ``m/<leaf>`` and
  ``v/<leaf>``;
* ``change``: the norm of each parameter's change over the steps;
* ``grad1``: the norm of each parameter's first (clipped) gradient, which
  decides the leaves that the change leaves out.

Norms are taken in float64.  ``initial(path)`` gives a parameter's
starting value; the benchmark makes it again from the seed rather than
keep a copy.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from reference import f32_matmuls
from reference.common import PRECISIONS
from reference.optim import (Optimizer, SketchPair, cs_adam_rows, dedup,
                             global_norm_clip)


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().to(torch.float64)))


def lm_steps(model, cfg: dict, params: Dict[str, torch.Tensor],
             batches: Sequence, *, lr: float, grad_clip: float,
             sketched: Sequence[str], compression: float, depth: int,
             initial: Callable[[str], torch.Tensor],
             precision: str = "f32") -> dict:
    """``len(batches)`` steps of ``model`` (a module with ``loss``) from
    ``params`` (modified in place), each batch ``(tokens, labels)``."""
    pr = PRECISIONS[precision]
    out: Dict[str, object] = {"loss": [], "state1": {}, "grad1": {},
                              "change": {}}
    with f32_matmuls():
        opt = Optimizer(params, lr=lr, sketched=sketched,
                        compression=compression, depth=depth)
        for t, (tokens, labels) in enumerate(batches, start=1):
            for p in params.values():
                p.requires_grad_(True)
            loss = model.loss(cfg, params, tokens, labels, pr)
            grads = torch.autograd.grad(loss, list(params.values()))
            for p in params.values():
                p.requires_grad_(False)
            grads = global_norm_clip(dict(zip(params, grads)), grad_clip)
            out["loss"].append(float(loss.detach()))
            opt.step(params, grads)
            if t == 1:
                out["grad1"] = {k: norm(g) for k, g in grads.items()}
                out["state1"] = {k: norm(s) for k, s in opt.state().items()}
            del grads, loss
        out["change"] = {k: norm(p - initial(k)) for k, p in params.items()}
    return out


def sparse_steps(table: torch.Tensor, target: torch.Tensor,
                 batches: List[torch.Tensor], *, lr: float, path: str,
                 compression: float, depth: int, width_multiple: int,
                 seed: int, initial: Callable[[str], torch.Tensor]) -> dict:
    """``len(batches)`` CS-Adam steps of ``table`` (modified in place)
    pulled toward ``target``: each batch is a (k,) id vector, its loss
    ``mean((table[ids] - target[ids])²)`` and its gradient rows
    ``table[ids] - target[ids]``."""
    out: Dict[str, object] = {"loss": [], "state1": {}, "grad1": {},
                              "change": {}}
    n, d = table.shape
    with f32_matmuls():
        sk = SketchPair(n, d, path=path, compression=compression,
                        depth=depth, width_multiple=width_multiple,
                        seed=seed, device=table.device)
        for t, ids in enumerate(batches, start=1):
            rows = table[ids.long()] - target[ids.long()]
            out["loss"].append(float(torch.mean(torch.square(rows))))
            cs_adam_rows(table, sk, ids, rows, t, lr=lr)
            if t == 1:
                out["grad1"] = {"table": norm(dedup(ids, rows)[1])}
                out["state1"] = {"m/table": norm(sk.M), "v/table": norm(sk.V)}
        out["change"] = {"table": norm(table - initial("table"))}
    return out
