"""Adam with its moments in count-sketches (the paper's Algorithm 4), in
plain float32 PyTorch, with whole-batch semantics: every read sees the
sketch as it was before the step, then the increments are added.

* ``cs_adam_rows``: one table fed ``(ids, rows)`` gradients with repeated
  ids; duplicates are summed first, then each unique row is updated once.
* ``Optimizer``: a parameter tree fed dense gradients.  Leaves named in
  ``sketched`` keep the 1st moment in a signed Count-Sketch (median read)
  and the 2nd in a Count-Min (min read), and rows whose gradient is all
  zero take no step (lazy); every other leaf takes dense Adam.

The first moment's increment is ``(1-b1)(g - m_old)`` and the second's
``(1-b2)(g² - v_old)``; the bias corrections are ``1 - b**t`` with the
power in float64, rounded to float32.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from reference.hashing import Hash, leaf_seed, sketch_width


def bias_correction(b: float, t: int) -> float:
    return float(np.float32(1.0) - np.float32(b ** t))


def median3(rows):
    hi = torch.maximum(torch.maximum(rows[0], rows[1]), rows[2])
    lo = torch.minimum(torch.minimum(rows[0], rows[1]), rows[2])
    return rows[0] + rows[1] + rows[2] - hi - lo


def _median(rows):
    if len(rows) == 3:
        return median3(rows)
    return torch.stack(rows).median(dim=0).values


class SketchPair:
    """The M (signed) and V (count-min) sketches of one (n, d) table."""

    def __init__(self, n: int, d: int, *, path: str, compression: float,
                 depth: int, width_multiple: int = 256, seed: int = 0,
                 device="cpu", dtype=torch.float32):
        width = sketch_width(n, compression, depth, width_multiple)
        self.hash = Hash(leaf_seed(path, seed), depth, width)
        self.M = torch.zeros((depth, width, d), dtype=dtype, device=device)
        self.V = torch.zeros((depth, width, d), dtype=dtype, device=device)

    def step(self, ids: torch.Tensor, g: torch.Tensor, mask, t: int, *,
             b1: float, b2: float, eps: float) -> torch.Tensor:
        """The direction ``m̂ / (√v̂ + eps)`` of rows ``ids`` (unique) with
        gradient ``g``; the sketches take the step in place.  ``mask``
        (k, 1) or None gates the increments."""
        h = self.hash
        bk, sg = h.bucket(ids), h.sign(ids)
        depth = h.depth
        m_rows = [self.M[j].index_select(0, bk[j]).float() * sg[j][:, None]
                  for j in range(depth)]
        m_old = _median(m_rows)
        dm = (1.0 - b1) * (g - m_old)
        v_old = self.V[0].index_select(0, bk[0]).float()
        for j in range(1, depth):
            v_old = torch.minimum(v_old, self.V[j].index_select(0, bk[j])
                                  .float())
        dv = (1.0 - b2) * (g * g - v_old)
        if mask is not None:
            dm, dv = dm * mask, dv * mask
        for j in range(depth):
            self.M[j].index_add_(0, bk[j], (sg[j][:, None] * dm)
                                 .to(self.M.dtype))
            self.V[j].index_add_(0, bk[j], dv.to(self.V.dtype))
        mhat = (m_old + dm) / bias_correction(b1, t)
        vhat = torch.clamp_min(v_old + dv, 0.0) / bias_correction(b2, t)
        return mhat / (torch.sqrt(vhat) + eps)


def dedup(ids: torch.Tensor, rows: torch.Tensor):
    """Sorted unique ids and the sum of each id's rows."""
    uids, inv = torch.unique(ids.to(torch.int64), sorted=True,
                             return_inverse=True)
    g = torch.zeros((uids.numel(), rows.shape[1]), dtype=rows.dtype,
                    device=rows.device).index_add_(0, inv, rows)
    return uids, g


def cs_adam_rows(table: torch.Tensor, sk: SketchPair, ids: torch.Tensor,
                 rows: torch.Tensor, t: int, *, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
    """One CS-Adam step of ``table`` at the rows ``ids`` (repeats
    allowed), in place."""
    uids, g = dedup(ids, rows)
    direction = sk.step(uids, g, None, t, b1=b1, b2=b2, eps=eps)
    table.index_add_(0, uids, -lr * direction)


def global_norm_clip(grads: Dict[str, torch.Tensor], max_norm: float):
    """Gradients scaled so that their global L2 norm is at most
    ``max_norm``."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


class Optimizer:
    """CS-Adam on the ``sketched`` leaves, dense Adam on the others, over
    a flat ``{path: tensor}`` parameter dict."""

    def __init__(self, params: Dict[str, torch.Tensor], *, lr: float,
                 sketched: Iterable[str], compression: float, depth: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 seed: int = 0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.sketch: Dict[str, SketchPair] = {}
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        for path, p in params.items():
            if path in sketched:
                n, d = p.shape
                self.sketch[path] = SketchPair(
                    n, d, path=path, compression=compression, depth=depth,
                    seed=seed, device=p.device)
            else:
                self.m[path] = torch.zeros_like(p)
                self.v[path] = torch.zeros_like(p)

    def state(self) -> Dict[str, torch.Tensor]:
        """Every moment tensor as ``{"m/<path>" | "v/<path>": tensor}``."""
        out = {}
        for path, sk in self.sketch.items():
            out["m/" + path], out["v/" + path] = sk.M, sk.V
        for path in self.m:
            out["m/" + path], out["v/" + path] = self.m[path], self.v[path]
        return out

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        t, b1, b2 = self.t, self.b1, self.b2
        for path, p in params.items():
            g = grads[path].float()
            if path in self.sketch:
                ids = torch.arange(p.shape[0], device=p.device)
                active = (g != 0).any(dim=-1, keepdim=True).float()
                direction = active * self.sketch[path].step(
                    ids, g, active, t, b1=b1, b2=b2, eps=self.eps)
            else:
                m, v = self.m[path], self.v[path]
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                direction = (m / bias_correction(b1, t)) / (
                    torch.sqrt(v / bias_correction(b2, t)) + self.eps)
            p.add_(-self.lr * direction)
