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
softmax; the reference has no Pallas kernel here.  That plain math lives
beside the kernels that stand for it, in ``kernels/flash_attn.py``.  On
a card, bf16 q, k and v at head_dim 64 or 128 take the flash attention
kernels (``_FlashKernel``), whose products keep that f32 precision, at
any length; ``_FlashCore`` is their plain version.  Both forwards, and
both backwards, run in the span ``obs.attn``.

Layouts:
  q        (b, s, hq, hd)
  k, v     (b, s, hkv, hd)         hq % hkv == 0 (GQA groups)
  cache    (b, S_max, hkv, hd)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.flash_attn import (NEG_INF, flash_grads,
                                            online_softmax, scaled_group)
from repro_torch.models import common as cm
from repro_torch.obs.profiling import scope


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
    out, _, _ = online_softmax(scaled_group(q, hkv), k, v, causal=causal,
                               chunk=chunk, q_offset=q_offset)
    return _ungroup(out, q.dtype)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length) -> torch.Tensor:
    """One-token attention against the cache.  q (b,1,hq,hd); cache_k/v
    (b,S,hkv,hd); ``length`` the valid prefix: a host int (compared on
    the card with no copy), or a () or (b,) tensor."""
    b, _, hq, hd = q.shape
    S, hkv = cache_k.shape[1], cache_k.shape[2]
    qg = scaled_group(q, hkv)                               # (b,1,hkv,g,hd)
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
        qg = scaled_group(q, hkv)
        o, m, l = online_softmax(qg, k, v, causal=causal, chunk=chunk,
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
        with scope("obs.attn"):
            dq, dk, dv = flash_grads(qg, k, v, o, lse, dout, causal=causal,
                                     chunk=chunk, q_offset=q_offset)
            return (dq.reshape(b, sq, hkv * g, hd).to(qdt), dk.to(k.dtype),
                    dv.to(v.dtype), None, None, None)


class _FlashKernel(torch.autograd.Function):
    """``_FlashCore`` on the card's kernels (``kernels/flash_attn.py``):
    saves (q, k, v, o, lse), o in f32 as ``_FlashCore`` saves it; the
    kernels round the f32 gradients to bf16, as ``_FlashCore`` rounds
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, o, lse = fa.flash_attn_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash = (causal, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        causal, q_offset = ctx.flash
        with scope("obs.attn"):
            dq, dk, dv = fa.flash_attn_bwd(
                q, k, v, o, lse, dout.to(q.dtype).contiguous(), causal,
                q_offset, out_dtype=q.dtype)
            return dq, dk, dv, None, None


def takes_kernel(q, k, v, q_offset: int = 0) -> bool:
    """Whether ``flash_attention`` sends a call to the kernels: CUDA
    tensors, all bf16, head_dim 64 or 128, ``q_offset`` not negative."""
    return (q.is_cuda and k.is_cuda and v.is_cuda
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in fa.HEAD_DIMS and q_offset >= 0)


def flash_attention(q, k, v, causal: bool = True, chunk: int = 1024,
                    q_offset: int = 0):
    """Memory-linear attention.  q (b,sq,hq,hd); k,v (b,skv,hkv,hd).
    Where ``takes_kernel`` holds, the kernels take the call at any
    length (``chunk`` means nothing to them).  Otherwise ``_FlashCore``
    over KV chunks, which matches ``chunked_attention`` to f32
    accumulation accuracy; a length the chunk does not divide falls back
    to ``chunked_attention``.  ``calls`` counts every call,
    ``kernel_calls`` those that took the kernels."""
    flash_attention.calls += 1
    with scope("obs.attn"):
        if takes_kernel(q, k, v, q_offset):
            flash_attention.kernel_calls += 1
            return _FlashKernel.apply(q, k, v, causal, q_offset)
        skv = k.shape[1]
        chunk = min(chunk, skv)
        if skv % chunk != 0:
            return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset)
        return _FlashCore.apply(q, k, v, causal, chunk, q_offset)


flash_attention.calls = 0
flash_attention.kernel_calls = 0


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
