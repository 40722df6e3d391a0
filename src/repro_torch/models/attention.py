"""GQA attention: the flash training path and the KV-cache serving path.

Counterpart of ``repro.models.attention``.  ``flash_attention`` is the
training path: an online softmax over KV chunks in one
``torch.autograd.Function`` whose forward saves only (o, logsumexp) and
whose backward forms each chunk's probabilities again instead of
keeping the (s × s) matrix.  ``chunked_attention`` (the same scan with
autograd's backward) is the oracle the tests hold it to.  Decode
attends one query against the whole cache.

Scores, softmax and the products are f32 ``torch.einsum``s, as the
reference computes them, so the port's numbers follow its f32 online
softmax; the reference has no Pallas kernel here.

Layouts:
  q        (b, s, hq, hd)
  k, v     (b, s, hkv, hd)         hq % hkv == 0 (GQA groups)
  cache    (b, S_max, hkv, hd)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import true_div
from repro_torch.models import common as cm

NEG_INF = -1e30


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    b, s, hq, hd = q.shape
    return q.reshape(b, s, hkv, hq // hkv, hd)


def _scaled_group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(b, sq, hkv, g, hd) f32 queries over √hd."""
    hd = q.shape[-1]
    return true_div(_group(q, hkv).to(torch.float32),
                    float(np.sqrt(np.float32(hd))))


def _causal_scores(qg, kb, c_idx: int, chunk: int, q_pos, causal: bool):
    """Scores (b, hkv, g, sq, chunk) of the pre-scaled queries against one
    KV chunk, masked to -1e30 past the causal frontier."""
    s = torch.einsum("bqhgd,bchd->bhgqc", qg, kb.to(torch.float32))
    if causal:
        k_pos = c_idx * chunk + torch.arange(chunk, device=qg.device)
        mask = q_pos[:, None] >= k_pos[None, :]               # (sq, chunk)
        s = torch.where(mask[None, None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device))
    return s


def _online_softmax(qg, k, v, *, causal: bool, chunk: int, q_offset: int):
    """qg (b,sq,hkv,g,hd) pre-scaled f32; k/v (b,skv,hkv,hd).  Returns
    (out (b,hkv,g,sq,hd) f32, m, l), the running max and sum."""
    b, sq, hkv, g, hd = qg.shape
    n_chunks = k.shape[1] // chunk
    q_pos = q_offset + torch.arange(sq, device=qg.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                      device=qg.device)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        s = _causal_scores(qg, kb, c, chunk, q_pos, causal)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out, m, l


def _ungroup(out: torch.Tensor, dtype) -> torch.Tensor:
    """(b,hkv,g,sq,hd) -> (b,sq,hq,hd) in ``dtype``."""
    b, hkv, g, sq, hd = out.shape
    return torch.movedim(out, 3, 1).reshape(b, sq, hkv * g, hd).to(dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks, differentiated by
    autograd (the tests' oracle).  q (b,sq,hq,hd); k,v (b,skv,hkv,hd);
    ``q_offset``: absolute position of q[0] relative to k[0].  Returns
    (b,sq,hq,hd)."""
    skv, hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, skv)
    if skv % chunk != 0:
        chunk = skv  # odd lengths (tests, ragged tails): single chunk
    out, _, _ = _online_softmax(_scaled_group(q, hkv), k, v, causal=causal,
                                chunk=chunk, q_offset=q_offset)
    return _ungroup(out, q.dtype)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length) -> torch.Tensor:
    """One-token attention against the cache.  q (b,1,hq,hd); cache_k/v
    (b,S,hkv,hd); ``length`` the valid prefix: a host int (compared on
    the card with no copy), or a () or (b,) tensor."""
    b, _, hq, hd = q.shape
    S, hkv = cache_k.shape[1], cache_k.shape[2]
    qg = _scaled_group(q, hkv)                                # (b,1,hkv,g,hd)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, cache_k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    if isinstance(length, torch.Tensor):
        length = torch.broadcast_to(length.to(q.device), (b,))[:, None]
    valid = torch.broadcast_to(pos[None] < length, (b, S))
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", p, cache_v.to(torch.float32))
    return _ungroup(out, q.dtype)


# ---------------------------------------------------------------------------
# Flash attention (backward forms each chunk's probabilities again)
# ---------------------------------------------------------------------------

class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP: saves (qg, k, v, o,
    lse) and runs the chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int, q_offset: int):
        hkv = k.shape[2]
        qg = _scaled_group(q, hkv)
        o, m, l = _online_softmax(qg, k, v, causal=causal, chunk=chunk,
                                  q_offset=q_offset)
        lse = m + torch.log(torch.clamp_min(l, 1e-30))
        ctx.save_for_backward(qg, k, v, o, lse)
        ctx.flash = (causal, chunk, q_offset, q.dtype)
        return _ungroup(o, q.dtype)

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, o, lse = ctx.saved_tensors
        causal, chunk, q_offset, qdt = ctx.flash
        b, sq, hkv, g, hd = qg.shape
        skv = k.shape[1]
        do = torch.movedim(
            dout.to(torch.float32).reshape(b, sq, hkv, g, hd), 1, 3)
        D = torch.sum(do * o, dim=-1)                     # (b,hkv,g,sq)
        q_pos = q_offset + torch.arange(sq, device=qg.device)
        dq = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32,
                         device=qg.device)
        dks, dvs = [], []
        for c in range(skv // chunk):
            kb = k[:, c * chunk:(c + 1) * chunk].to(torch.float32)
            vb = v[:, c * chunk:(c + 1) * chunk].to(torch.float32)
            s = _causal_scores(qg, kb, c, chunk, q_pos, causal)
            p = torch.exp(s - lse[..., None])             # (b,hkv,g,sq,c)
            dvs.append(torch.einsum("bhgqc,bhgqd->bchd", p, do))
            dp = torch.einsum("bhgqd,bchd->bhgqc", do, vb)
            ds = p * (dp - D[..., None])
            dq = dq + torch.einsum("bhgqc,bchd->bqhgd", ds, kb)
            dks.append(torch.einsum("bhgqc,bqhgd->bchd", ds, qg))
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
        dq = (dq * scale).reshape(b, sq, hkv * g, hd).to(qdt)
        dk = torch.cat(dks, dim=1).to(k.dtype)
        dv = torch.cat(dvs, dim=1).to(v.dtype)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, chunk: int = 1024,
                    q_offset: int = 0):
    """Memory-linear attention.  q (b,sq,hq,hd); k,v (b,skv,hkv,hd).
    Matches ``chunked_attention`` to f32 accumulation accuracy; ragged
    sequence lengths fall back to it."""
    skv = k.shape[1]
    chunk = min(chunk, skv)
    if skv % chunk != 0:
        return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                 q_offset=q_offset)
    return _FlashCore.apply(q, k, v, causal, chunk, q_offset)


def attn_init(generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False, *, lead=(),
              device="cuda"):
    """One attention block's params; ``lead`` stacks them ((n_layers,)
    for a layer stack)."""
    lead = tuple(lead)
    p = {
        "wq": cm.dense_init(generator, d_model, n_heads * head_dim,
                            lead=lead, device=device),
        "wk": cm.dense_init(generator, d_model, n_kv * head_dim,
                            lead=lead, device=device),
        "wv": cm.dense_init(generator, d_model, n_kv * head_dim,
                            lead=lead, device=device),
        "wo": cm.dense_init(generator, n_heads * head_dim, d_model,
                            lead=lead, device=device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (width * head_dim,),
                                  dtype=torch.float32, device=device)
    return p


def attn_qkv(p, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def attn_out(p, o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype)
