"""Pieces the plain model references share: the precision they compute
in, RMSNorm, rotary position embeddings and the mean token
cross-entropy.

A ``Precision`` gives the products (``mm``) and the rounding of every
value that the program holds in its compute dtype (``rd``: activations,
projections, the residual stream, logits).  ``PRECISIONS["f32"]`` is the
reference: float32 products, nothing rounded.  ``PRECISIONS["fp8"]`` is
the control for configurations that state bfloat16: the same values held
in float8 (e4m3 forward, e5m2 gradients, per-tensor scales) and the
products of float8 inputs, the precision below bfloat16.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _round8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 format under one per-tensor scale (its
    absolute maximum mapped to the format's largest finite value), back
    in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``x @ w`` with both inputs rounded to float8 e4m3, and in the
    backward the incoming gradient rounded to float8 e5m2 and each
    product's other input to e4m3, every product accumulated in float32:
    the recipe of float8 training (e4m3 forward, e5m2 gradients)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round8(x), _round8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round8(g, torch.float8_e5m2)
        gx = gq @ wq.transpose(-1, -2)
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw.reshape(wq.shape)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product computed in float8 (``_Fp8Matmul``)."""
    return _Fp8Matmul.apply(x, w)


class _Fp8Round(torch.autograd.Function):
    """A value held in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


class Precision(NamedTuple):
    mm: Matmul
    rd: Callable[[torch.Tensor], torch.Tensor]


PRECISIONS = {"f32": Precision(matmul, lambda x: x),
              "fp8": Precision(fp8_matmul, fp8_round)}
F32 = PRECISIONS["f32"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (b, s, heads, hd) at positions 0..s-1, the
    two halves of each head rotated together."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def xent(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
         pr: Precision, chunk: Optional[int] = 2048) -> torch.Tensor:
    """Mean cross-entropy of the final hidden states x (N, d) through the
    vocabulary table ``head`` (V, d) against ``labels`` (N,), over every
    class, in row chunks whose logits are formed again in the backward."""
    from torch.utils.checkpoint import checkpoint

    def part(xc, lc):
        logits = pr.rd(pr.mm(xc, head.T))
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lc[:, None].long())[:, 0]).sum()

    n = x.shape[0]
    chunk = chunk or n
    total = sum(checkpoint(part, x[i:i + chunk], labels[i:i + chunk],
                           use_reentrant=False)
                for i in range(0, n, chunk))
    return total / n
