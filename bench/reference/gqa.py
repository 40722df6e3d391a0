"""A decoder-only transformer with grouped-query attention (Qwen2):
RMSNorm, Q/K/V projections with biases, rotary embeddings, causal
softmax attention in which each group of ``n_heads / n_kv`` query heads
shares one K/V head, a SwiGLU feed-forward, a final RMSNorm and an
untied vocabulary head.  Plain float32 PyTorch; each layer runs under
``torch.utils.checkpoint`` so that 24 layers of (b, heads, s, s) scores
are not all kept.

Parameters are a flat dict keyed by the port's leaf paths
(``tok_embed/table``, ``layers/attn/wq`` stacked over layers, ...).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import F32, Precision, rmsnorm, rope, xent


def _layer(cfg: dict, P: Dict[str, torch.Tensor], i: int, x,
           pr: Precision):
    b, s, d = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    L = lambda name: P["layers/" + name][i]          # noqa: E731
    mm, rd = pr.mm, pr.rd
    h = rd(rmsnorm(x, L("ln1")))
    q = rd(mm(h, L("attn/wq")) + L("attn/bq"))
    k = rd(mm(h, L("attn/wk")) + L("attn/bk"))
    v = rd(mm(h, L("attn/wv")) + L("attn/bv"))
    q = rd(rope(q.view(b, s, H, hd), cfg["rope_theta"]))
    k = rd(rope(k.view(b, s, KV, hd), cfg["rope_theta"]))
    v = v.view(b, s, KV, hd)
    g = H // KV
    k = k.repeat_interleave(g, dim=2)                # head h reads kv h // g
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (b, H, s, hd)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = rd(torch.matmul(probs, v).transpose(1, 2).reshape(b, s, H * hd))
    x = rd(x + rd(mm(o, L("attn/wo"))))
    h = rd(rmsnorm(x, L("ln2")))
    gate = rd(F.silu(rd(mm(h, L("ffn/w_gate")))))
    f = rd(gate * rd(mm(h, L("ffn/w_up"))))
    return rd(x + rd(mm(f, L("ffn/w_down"))))


def loss(cfg: dict, P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, pr: Precision = F32) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens (b, s) against labels."""
    x = pr.rd(P["tok_embed/table"][tokens.long()])
    for i in range(cfg["n_layers"]):
        x = checkpoint(_layer, cfg, P, i, x, pr, use_reentrant=False)
    x = pr.rd(rmsnorm(x, P["final_norm"]))
    return xent(x.reshape(-1, x.shape[-1]), P["lm_head/table"],
                labels.reshape(-1), pr)
