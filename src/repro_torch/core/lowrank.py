"""Low-rank baselines the paper compares against (§6, §7), in PyTorch.

Counterpart of ``repro.core.lowrank``.

* ``nmf_rank1_adam``: Adam with the 2nd moment of policy-selected leaves
  held as the non-negative rank-1 factorization of Shazeer & Stern
  (Adafactor), the paper's LR-NMF-V baseline (the 1st moment stays
  dense).  ``core.stores.Rank1Store`` runs the same numbers inside
  ``scale_by_adam``.
* ``l2_rank1_*``: the ℓ2 rank-1 oracle of the paper's Fig. 4, tracked by
  warm-started power iteration in place of a full SVD per step.

The step counter is a host int32 tensor and the bias corrections take
``b**t`` in f64, rounded (``ops.bias_correction``), as in the port's
other transforms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.partition import PolicyFn, nothing_policy
from repro_torch.core.stores import Rank1Moment
from repro_torch.core.transforms import (Schedule, Transform, _host_step,
                                         _lr_at, _unzip, tree_map_with_path)
from repro_torch.kernels.ops import bias_correction
from repro_torch.kernels.ref import true_div


def nmf_rank1_adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-30, *,
                   policy: PolicyFn = nothing_policy) -> Transform:
    """Adam whose policy-selected (n, d) leaves keep the 2nd moment as
    row and column vectors (a ``Rank1Moment``):

        R <- β₂R + (1-β₂)·row_mean(g²)
        C <- β₂C + (1-β₂)·col_mean(g²)
        V̂[i, j] = R[i]·C[j] / mean(R)

    The reconstruction builds the whole (n, d) V̂ every step, the cost
    the paper's Tab. 1 holds against low-rank.  State ``{"step", "m",
    "v"}``; the update is ``-η·m̂ / (√(V̂/bc₂) + 1e-8)``."""

    def init(params):
        def v_leaf(path, p):
            if policy(path, tuple(p.shape)):
                return Rank1Moment(
                    torch.zeros(p.shape[0], dtype=torch.float32,
                                device=p.device),
                    torch.zeros(p.shape[1], dtype=torch.float32,
                                device=p.device))
            return torch.zeros_like(p)

        return {"step": _host_step(),
                "m": tree_map_with_path(lambda _p, p: torch.zeros_like(p),
                                        params),
                "v": tree_map_with_path(v_leaf, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        eta, t = _lr_at(lr, step), int(step)
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)

        def leaf(_path, g, M, V):
            m_new = b1 * M + (1.0 - b1) * g
            mhat = true_div(m_new, bc1)
            if isinstance(V, Rank1Moment):
                g2 = torch.square(g.to(torch.float32))
                r = b2 * V.r + (1.0 - b2) * g2.mean(dim=1)
                c = b2 * V.c + (1.0 - b2) * g2.mean(dim=0)
                vhat = nmf_rank1_reconstruct(r, c, eps)
                v_out = Rank1Moment(r, c)
            else:
                vhat = b2 * V + (1.0 - b2) * g * g
                v_out = vhat
            upd = -eta * mhat / (torch.sqrt(torch.clamp_min(
                true_div(vhat, bc2), 0.0)) + 1e-8)
            return m_new, v_out, upd

        m, v, ups = _unzip(grads, tree_map_with_path(
            leaf, grads, state["m"], state["v"]), 3)
        return ups, {"step": step, "m": m, "v": v}

    return Transform(init, update)


def nmf_rank1_reconstruct(r: torch.Tensor, c: torch.Tensor,
                          eps: float = 1e-30) -> torch.Tensor:
    return (r[:, None] * c[None, :]) / (r.mean() + eps)


class Rank1State(NamedTuple):
    u: torch.Tensor  # (n,)
    s: torch.Tensor  # ()
    v: torch.Tensor  # (d,)


def l2_rank1_init(shape, device="cuda") -> Rank1State:
    n, d = shape
    one = torch.ones((), dtype=torch.float32, device=device)
    return Rank1State(
        u=torch.full((n,), 1.0, device=device) * (one / torch.sqrt(one * n)),
        s=torch.zeros((), dtype=torch.float32, device=device),
        v=torch.full((d,), 1.0, device=device) * (one / torch.sqrt(one * d)))


def l2_rank1_step(state: Rank1State, target: torch.Tensor,
                  iters: int = 2) -> Rank1State:
    """The top singular triplet of ``target``, tracked by warm-started
    power iteration (the practical stand-in for the paper's per-step
    SVD)."""
    v, u, s = state.v, state.u, state.s
    for _ in range(iters):
        u = target @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = target.T @ u
        s = torch.linalg.vector_norm(v)
        v = v / (s + 1e-12)
    return Rank1State(u=u, s=s, v=v)


def l2_rank1_reconstruct(state: Rank1State) -> torch.Tensor:
    return state.s * torch.outer(state.u, state.v)
