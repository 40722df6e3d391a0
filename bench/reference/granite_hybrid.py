"""GraniteMoeHybrid (granite-4.0-h) as the port's ``hybrid_moe``
configuration runs it, in plain float32 PyTorch.

Per layer i, its mixer Mamba2 or attention as ``layer_types[i]`` says,
and m the residual multiplier:

    h  = x + m·mixer(rmsnorm(x))
    x' = h + m·(moe(rmsnorm(h)) + shared(rmsnorm(h)))

The stack starts from the embedding times the embedding multiplier and
ends with the final RMSNorm and the head's logits over the logits
scaling; the loss is the mean token cross-entropy alone.

* Mamba2: z, x, B·C and dt projections without bias; a depthwise causal
  conv of width 4 with bias and silu on x and on B·C (``F.conv1d``);
  dt = softplus(dt + dt_bias), A = −exp(A_log); the SSD by the chunked
  dual form of the Mamba-2 paper's minimal listing (arXiv:2405.21060,
  ``ssd_minimal_discrete``) with chunks of 64, B and C shared by the
  heads (one group); y + D·x; the gated norm rmsnorm(y·silu(z)), gate
  first; the output projection.
* Attention: GQA without bias and without position embedding, softmax
  scale ``attention_multiplier``, computed in blocks of query rows (each
  under ``torch.utils.checkpoint``) so that every head's full score
  matrix is never held at once.
* MoE: the router's logits over all experts, the ``top_k`` largest, the
  gates a softmax over them; only the experts this device holds
  (``experts_held`` from ``expert_rank · experts_held``) are computed,
  by a plain loop over them, each a SwiGLU of its tokens times their
  gate; the shared SwiGLU expert on every token.

Parameters are a flat dict keyed by the port's leaf paths
(``layers/mamba/z_proj`` stacked over the Mamba2 layers,
``layers/attn/wq`` over the attention layers, ``layers/ffn/router`` and
the held experts' ``layers/ffn/w_gate`` (layers, held, d, f) over all
layers).  Each layer runs under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import F32, Precision, rmsnorm

SSD_CHUNK = 64
QUERY_BLOCK = 512
LOSS_CHUNK = 2048


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry (i, j) the sum of a[j+1 .. i] for
    j ≤ i, −inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)          # x[..., i, j] = a[i]
    below = torch.ones((T, T), dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones((T, T), dtype=torch.bool, device=a.device).tril(0)
    return x.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, chunk: int = SSD_CHUNK):
    """The minimal SSD: X (b, s, h, p) = x·dt, A (b, s, h) = a·dt, B and
    C (b, s, n) shared by the heads.  Returns Y (b, s, h, p), with
    Y_t = Σ_{j≤t} (C_t·B_j) exp(A_{j+1} + … + A_t) X_j."""
    b, s, h, p = X.shape
    n = B.shape[-1]
    c = s // chunk
    X = X.reshape(b, c, chunk, h, p)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # (b, h, c, l)
    B = B.reshape(b, c, chunk, n)
    C = C.reshape(b, c, chunk, n)
    A_cs = torch.cumsum(A, dim=-1)
    # 1. the diagonal blocks
    L = torch.exp(_segsum(A))                                 # (b,h,c,l,s)
    CB = torch.einsum("bcln,bcsn->bcls", C, B)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, X)
    # 2. each chunk's state
    decay = torch.exp(A_cs[..., -1:] - A_cs)                  # (b, h, c, l)
    states = torch.einsum("bcln,bclhp->bchpn", B,
                          X * decay.permute(0, 2, 3, 1)[..., None])
    # 3. the states passed from chunk to chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(A_cs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. the state's part of each output
    Y_off = torch.einsum("bcln,bchpn->bclhp", C, states) \
        * torch.exp(A_cs).permute(0, 2, 3, 1)[..., None]
    return (Y_diag + Y_off).reshape(b, s, h, p)


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal conv of x (b, s, ch) with taps w (K, ch), w[0]
    on the current position, then silu."""
    K, ch = w.shape
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)),
                 w.flip(0).T[:, None, :], bias, groups=ch)
    return F.silu(y.transpose(1, 2))


def _mamba(cfg: dict, L, xn, pr: Precision):
    b, s, d = xn.shape
    mm, rd = pr.mm, pr.rd
    hp, n = cfg["ssm_head_dim"], cfg["ssm_state"]
    di = cfg["ssm_expand"] * d
    h = di // hp
    z = rd(mm(xn, L("z_proj")))
    x = rd(_conv(rd(mm(xn, L("x_proj"))), L("conv_w_x"), L("conv_b_x")))
    bc = rd(_conv(rd(mm(xn, L("bc_proj"))), L("conv_w_bc"),
                  L("conv_b_bc")))
    dt = F.softplus(rd(mm(xn, L("dt_proj"))) + L("dt_bias"))  # (b, s, h)
    A = -torch.exp(L("A_log")) * dt
    xh = x.reshape(b, s, h, hp)
    y = ssd(xh * dt[..., None], A, bc[..., :n], bc[..., n:])
    y = (y + L("D")[:, None] * xh).reshape(b, s, di)
    y = rd(rmsnorm(y * F.silu(z), L("gn"), cfg["norm_eps"]))
    return rd(mm(y, L("out_proj")))


def _attend(q, k, v, scale: float, lo: int):
    """Rows lo .. lo + len(q) of causal attention: q (b, H, r, hd) against
    k, v (b, H, lo + r, hd)."""
    r = q.shape[2]
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    qpos = lo + torch.arange(r, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def _attention(cfg: dict, L, xn, pr: Precision):
    b, s, d = xn.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    mm, rd = pr.mm, pr.rd
    q = rd(mm(xn, L("wq"))).view(b, s, H, hd).transpose(1, 2)
    k = rd(mm(xn, L("wk"))).view(b, s, KV, hd).transpose(1, 2)
    v = rd(mm(xn, L("wv"))).view(b, s, KV, hd).transpose(1, 2)
    k = k.repeat_interleave(H // KV, dim=1)       # head h reads kv h // g
    v = v.repeat_interleave(H // KV, dim=1)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        outs.append(checkpoint(_attend, q[:, :, lo:hi], k[:, :, :hi],
                               v[:, :, :hi], cfg["attention_multiplier"],
                               lo, use_reentrant=False))
    o = rd(torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, H * hd))
    return rd(mm(o, L("wo")))


def _swiglu(x, wg, wu, wd, pr: Precision):
    mm, rd = pr.mm, pr.rd
    return rd(mm(rd(rd(F.silu(rd(mm(x, wg)))) * rd(mm(x, wu))), wd))


def _moe(cfg: dict, L, xn, pr: Precision):
    b, s, d = xn.shape
    x = xn.reshape(b * s, d)
    K = cfg["top_k"]
    held = cfg.get("experts_held") or cfg["n_experts"]
    first = cfg.get("expert_rank", 0) * held
    logits = pr.rd(pr.mm(x, L("router")))
    top, idx = torch.topk(logits, K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in range(held):
        chosen = idx == first + e                              # (T, K)
        tok = chosen.any(dim=-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        g = (gates * chosen)[tok].sum(-1, keepdim=True)
        out = _swiglu(x[tok], L("w_gate")[e], L("w_up")[e],
                      L("w_down")[e], pr)
        y = y.index_add(0, tok, pr.rd(out * g))
    shared = _swiglu(x, L("shared/w_gate"), L("shared/w_up"),
                     L("shared/w_down"), pr)
    return pr.rd(y + shared).reshape(b, s, d)


def _layer(cfg: dict, P: Dict[str, torch.Tensor], kind: str, j: int,
           i: int, x, pr: Precision):
    rd, eps, m = pr.rd, cfg["norm_eps"], cfg["residual_multiplier"]
    group = "mamba" if kind == "mamba" else "attn"
    Lmix = lambda name: P[f"layers/{group}/{name}"][j]       # noqa: E731
    Lffn = lambda name: P[f"layers/ffn/{name}"][i]           # noqa: E731
    xn = rd(rmsnorm(x, Lmix("ln"), eps))
    mix = _mamba if kind == "mamba" else _attention
    h = rd(x + rd(mix(cfg, Lmix, xn, pr) * m))
    hn = rd(rmsnorm(h, Lffn("ln"), eps))
    return rd(h + rd(_moe(cfg, Lffn, hn, pr) * m))


def _xent_part(x, head, labels, pr: Precision, divisor: float):
    logits = pr.rd(pr.mm(x, head.T)) / divisor
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None].long())[:, 0]).sum()


def loss(cfg: dict, P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, pr: Precision = F32) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens (b, s) against labels."""
    x = pr.rd(P["tok_embed/table"][tokens.long()]
              * cfg["embedding_multiplier"])
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"][:cfg["n_layers"]]):
        x = checkpoint(_layer, cfg, P, kind, seen[kind], i, x, pr,
                       use_reentrant=False)
        seen[kind] += 1
    x = pr.rd(rmsnorm(x, P["final_norm"], cfg["norm_eps"]))
    x, labels = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    total = sum(checkpoint(_xent_part, x[i:i + LOSS_CHUNK],
                           P["lm_head/table"], labels[i:i + LOSS_CHUNK], pr,
                           cfg["logits_scaling"], use_reentrant=False)
                for i in range(0, x.shape[0], LOSS_CHUNK))
    return total / x.shape[0]
