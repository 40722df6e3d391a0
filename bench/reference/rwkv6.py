"""RWKV-6 ("Finch") as the port's configuration runs it, in plain float32
PyTorch.  Per layer: RMSNorm, the time mix, RMSNorm, the channel mix,
each added to the residual.

Time mix: a token shift (position 0 sees zeros) and a static lerp per
input, ``x + mix * (x_prev - x)``; r, k, v, g projections; the
data-dependent decay ``log w = -exp(w_base + tanh(x_w A) B)`` clipped to
[-4, -1e-6]; per head (K = V = 64) the recurrence

    out_t   = r_t · (S_t + diag(u) k_t v_tᵀ)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ,      S_0 = 0

then an RMSNorm over all of d (weight ``gn``), times silu(g), and the
output projection.  Channel mix: ``sigmoid(x_r Wr) * (relu(x_k Wk)² Wv)``.

This departs from the published Finch block as the port does: the token
shift's lerps are static (no data-dependent ddlerp), the norms are
RMSNorms and the head-group norm is one RMSNorm over d.

The recurrence runs in chunks: within a chunk, the pair (t, j < t) is
weighted by ``exp(lwX_t - lwI_j)`` formed from the two cumulative
log-decays directly (lwI inclusive, lwX exclusive), never from a
product of ``exp(lwX)`` and ``exp(-lwI)``; the state passes from chunk
to chunk.  Each layer runs under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import F32, Precision, rmsnorm, xent

LOG_DECAY_CLIP = 4.0


def _chunk(rc, kc, vc, lw, u, S):
    """One chunk: (out (b, L, h, K), the state after it)."""
    L = rc.shape[1]
    lwI = torch.cumsum(lw, dim=1)                            # (b, L, h, K)
    lwX = lwI - lw
    # (b, h, t, j, K) decay of the pair (t, j) over steps j+1 .. t-1
    expo = lwX.permute(0, 2, 1, 3)[:, :, :, None] \
        - lwI.permute(0, 2, 1, 3)[:, :, None]
    strict = torch.ones((L, L), dtype=torch.bool,
                        device=rc.device).tril(-1)[None, None, :, :, None]
    pair = torch.where(strict, torch.exp(torch.where(strict, expo, 0.0)),
                       0.0)
    att = torch.einsum("bthk,bhtjk->bhtjk", rc, pair)
    att = torch.einsum("bhtjk,bjhk->bhtj", att, kc)
    out = torch.einsum("bhtj,bjhv->bthv", att, vc)
    out = out + (rc * u * kc).sum(-1, keepdim=True) * vc
    out = out + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(lwX), S)
    tail = torch.exp(lwI[:, -1:] - lwI)                      # (b, L, h, K)
    S = torch.exp(lwI[:, -1])[..., None] * S + torch.einsum(
        "bjhk,bjhv->bhkv", kc * tail, vc)
    return out, S


def wkv(r, k, v, logw, u, chunk: int):
    """r, k, v, logw (b, s, h, K); u (h, K).  Returns out (b, s, h, K).
    Each chunk runs under ``torch.utils.checkpoint``: only one chunk's
    (b, h, L, L, K) pair weights are alive in the backward."""
    b, s, h, K = r.shape
    S = torch.zeros((b, h, K, K), dtype=r.dtype, device=r.device)
    outs = []
    for c in range(0, s, chunk):
        out, S = checkpoint(_chunk, *(t[:, c:c + chunk]
                                      for t in (r, k, v, logw)), u, S,
                            use_reentrant=False)
        outs.append(out)
    return torch.cat(outs, dim=1)


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _layer(cfg: dict, P: Dict[str, torch.Tensor], i: int, x,
           pr: Precision):
    b, s, d = x.shape
    hd = cfg["rwkv_head_dim"]
    h = d // hd
    L = lambda name: P["layers/" + name][i]          # noqa: E731
    mm, rd = pr.mm, pr.rd
    y = rd(rmsnorm(x, L("ln1")))
    ys = _shift(y)
    lerp = lambda mix: rd(y + mix * (ys - y))        # noqa: E731
    r = rd(mm(lerp(L("tm/mix_r")), L("tm/wr"))).view(b, s, h, hd)
    k = rd(mm(lerp(L("tm/mix_k")), L("tm/wk"))).view(b, s, h, hd)
    v = rd(mm(lerp(L("tm/mix_v")), L("tm/wv"))).view(b, s, h, hd)
    g = rd(mm(lerp(L("tm/mix_g")), L("tm/wg")))
    # the decay's low-rank path is float32 in every precision
    dd = torch.tanh(lerp(L("tm/mix_w")) @ L("tm/w_A")) @ L("tm/w_B")
    logw = torch.clamp(-torch.exp(L("tm/w_base") + dd), -LOG_DECAY_CLIP,
                       -1e-6).view(b, s, h, hd)
    o = wkv(r, k, v, logw, L("tm/u"), cfg["rwkv_chunk"]).reshape(b, s, d)
    o = rd(rmsnorm(o, L("tm/gn")) * F.silu(g))
    x = rd(x + rd(mm(o, L("tm/wo"))))
    y = rd(rmsnorm(x, L("ln2")))
    ys = _shift(y)
    xk = rd(y + L("cm/mix_k") * (ys - y))
    xr = rd(y + L("cm/mix_r") * (ys - y))
    kk = rd(torch.relu(rd(mm(xk, L("cm/wk")))) ** 2)
    gate = rd(torch.sigmoid(rd(mm(xr, L("cm/wr")))))
    return rd(x + rd(gate * rd(mm(kk, L("cm/wv")))))


def loss(cfg: dict, P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, pr: Precision = F32) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens (b, s) against labels."""
    x = pr.rd(P["tok_embed/table"][tokens.long()])
    for i in range(cfg["n_layers"]):
        x = checkpoint(_layer, cfg, P, i, x, pr, use_reentrant=False)
    x = pr.rd(rmsnorm(x, P["final_norm"]))
    return xent(x.reshape(-1, x.shape[-1]), P["lm_head/table"],
                labels.reshape(-1), pr)
