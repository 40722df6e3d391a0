"""B10 · flash attention on bf16 q, k, v: forward and backward kernels,
and the plain attention math they stand for.

Replaces no TPU kernel: the reference's attention is XLA
(``repro/models/attention.py``).  The plain math is here: the online
softmax over KV chunks (``online_softmax``) and its backward
(``flash_grads``), f32 einsums, which ``models.attention`` runs as
``_FlashCore`` and ``chunked_attention``.  The CUDA kernels
(``csrc/flash_attn.cu``) keep a tile of query rows in a block, stream
K/V tiles through shared memory and run the products on the tensor
cores with f32 accumulation: q k^T and dO v^T as one bf16 MMA (bf16
products are exact in f32), every product with the f32 P or dS as an
exact three-term bf16 split (three MMAs), so each product has the plain
version's precision.  The softmax, ``exp`` and ``lse`` are f32.  The
backward (a rowsum pass, a dK/dV kernel over the group's query rows, a
dQ kernel over the KV tiles) uses no atomics: two calls give the same
bits.  Bound on the card: the tensor cores for long sequences.

The wrappers take CUDA tensors only (``models.attention.flash_attention``
routes every other input to ``_FlashCore``) and raise on what the
kernels do not take.  Each counts its calls in ``launches`` and reports
its work to a running ``OpCost`` (``obs.profiling.kernel_work``): the
FLOPs of the plain version's products (``plain_flops``), so a step
counts the same on every device.  ``flash_attn_fwd_plain`` and
``flash_attn_bwd_plain`` are the plain math in the kernels' layouts, on
any device: the tests hold the kernels to them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import true_div
from repro_torch.obs.profiling import kernel_work

HEAD_DIMS = (64, 128)
NEG_INF = -1e30


def scale_of(hd: int, scale: Optional[float] = None) -> float:
    """The softmax scale: ``scale``, or by default ``f32(1) /
    sqrt(f32(hd))``, as the plain backward multiplies dq by it."""
    if scale is not None:
        return float(np.float32(scale))
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def scaled_group(q: torch.Tensor, hkv: int,
                 scale: Optional[float] = None) -> torch.Tensor:
    """(b, sq, hq, hd) -> (b, sq, hkv, g, hd) f32 queries over √hd, or
    times ``scale`` where one is given."""
    b, s, hq, hd = q.shape
    qg = q.reshape(b, s, hkv, hq // hkv, hd).to(torch.float32)
    if scale is not None:
        return qg * scale_of(hd, scale)
    return true_div(qg, float(np.sqrt(np.float32(hd))))


def causal_scores(qg, kb, c_idx: int, chunk: int, q_pos, causal: bool):
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


def online_softmax(qg, k, v, *, causal: bool, chunk: int, q_offset: int):
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
        s = causal_scores(qg, kb, c, chunk, q_pos, causal)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out, m, l


def flash_grads(qg, k, v, o, lse, dout, *, causal: bool, chunk: int,
                q_offset: int, scale: Optional[float] = None):
    """The backward of ``online_softmax`` in f32: qg (b,sq,hkv,g,hd)
    pre-scaled by ``scale_of(hd, scale)``, o (b,hkv,g,sq,hd), lse
    (b,hkv,g,sq), dout (b,sq,hq,hd).  Returns (dq (b,sq,hkv,g,hd), dk,
    dv (b,skv,hkv,hd)), each chunk's probabilities formed again from
    lse."""
    b, sq, hkv, g, hd = qg.shape
    skv = k.shape[1]
    do = torch.movedim(
        dout.to(torch.float32).reshape(b, sq, hkv, g, hd), 1, 3)
    D = torch.sum(do * o, dim=-1)                         # (b,hkv,g,sq)
    q_pos = q_offset + torch.arange(sq, device=qg.device)
    dq = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32,
                     device=qg.device)
    dks, dvs = [], []
    for c in range(skv // chunk):
        kb = k[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        vb = v[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        s = causal_scores(qg, kb, c, chunk, q_pos, causal)
        p = torch.exp(s - lse[..., None])                 # (b,hkv,g,sq,c)
        dvs.append(torch.einsum("bhgqc,bhgqd->bchd", p, do))
        dp = torch.einsum("bhgqd,bchd->bhgqc", do, vb)
        ds = p * (dp - D[..., None])
        dq = dq + torch.einsum("bhgqc,bchd->bqhgd", ds, kb)
        dks.append(torch.einsum("bhgqc,bqhgd->bchd", ds, qg))
    return (dq * scale_of(hd, scale), torch.cat(dks, dim=1),
            torch.cat(dvs, dim=1))


def plain_flops(q: torch.Tensor, k: torch.Tensor, backward: bool) -> float:
    """The FLOPs of the plain version's products, as ``OpCost`` counts
    its einsums: every KV chunk whole (the causal mask comes after), two
    products a forward (S, P v), five a backward (S, dV, dP, dQ, dK)."""
    b, sq, hq, hd = q.shape
    return float((5 if backward else 2) * 2 * b * hq * sq * k.shape[1] * hd)


def _chunk(skv: int, chunk: int) -> int:
    chunk = min(chunk, skv)
    return chunk if skv % chunk == 0 else skv


def _lse_rows(lse: torch.Tensor) -> torch.Tensor:
    """(b, hkv, g, sq) -> the kernels' (b, hkv, sq * g)."""
    b, hkv, g, sq = lse.shape
    return lse.transpose(2, 3).reshape(b, hkv, sq * g)


def flash_attn_fwd_plain(q, k, v, causal: bool, q_offset: int,
                         chunk: int = 1024, scale: Optional[float] = None):
    """``flash_attn_fwd`` by the einsums of ``online_softmax``."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o, m, l = online_softmax(scaled_group(q, hkv, scale), k, v,
                             causal=causal,
                             chunk=_chunk(skv, chunk), q_offset=q_offset)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    o = torch.movedim(o, 3, 1).reshape(b, sq, hq, hd)
    return o.to(q.dtype), o, _lse_rows(lse)


def flash_attn_bwd_plain(q, k, v, o, lse, dout, causal: bool,
                         q_offset: int, chunk: int = 1024,
                         scale: Optional[float] = None):
    """``flash_attn_bwd`` by ``flash_grads`` (f32 results)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    og = torch.movedim(o.reshape(b, sq, hkv, g, hd), 1, 3)
    lg = lse.reshape(b, hkv, sq, g).transpose(2, 3)
    dq, dk, dv = flash_grads(scaled_group(q, hkv, scale), k, v, og, lg,
                             dout, causal=causal, chunk=_chunk(skv, chunk),
                             q_offset=q_offset, scale=scale)
    return dq.reshape(b, sq, hq, hd), dk, dv


def _check(name: str, q, k, v, q_offset: int, **more) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    b, sq, hq, hd = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != hd or hq % k.shape[2] != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    for key, t in dict(q=q, k=k, v=v, **more).items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = torch.float32 if key in ("o", "lse") else torch.bfloat16
        if t.dtype != want:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected "
                             f"{want}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, q_offset: int,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (b, sq, hq, hd), k and v (b, skv, hkv, hd), bf16; the softmax
    scale ``scale_of(hd, scale)``.  Returns
    ``(out, o, lse)``: out (b, sq, hq, hd) bf16, the rounding of the f32
    o of the same shape, and lse (b, hkv, sq * g) f32, row ``r`` of KV
    head ``h`` being position ``r // g`` of query head ``h * g + r % g``."""
    _check("flash_attn_fwd", q, k, v, q_offset)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, hkv, sq * (hq // hkv)), dtype=torch.float32,
                      device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.flash_attn_fwd_launch(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            build.ptr(out), build.ptr(lse), b, sq, skv, hq, hkv, hd,
            int(causal), int(q_offset), scale_of(hd, scale),
            build.stream_handle(dev))
    build.check_launch(rc, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    kernel_work("flash_attn_fwd", plain_flops(q, k, False),
                (q, k, v, o, out, lse))
    return out, o, lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool, q_offset: int,
                   out_dtype: torch.dtype = torch.float32,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attn_fwd`` for ``dout`` (q's shape, bf16).
    Returns ``(dq, dk, dv)`` in q's and k's shapes: f32, or with
    ``out_dtype`` bf16 the f32 values rounded to bf16 by the kernels."""
    _check("flash_attn_bwd", q, k, v, q_offset, o=o, lse=lse, dout=dout)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attn_bwd: out_dtype {out_dtype} is not "
                         f"float32 or bfloat16")
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hkv, sq * (hq // hkv)):
        raise ValueError(f"flash_attn_bwd: o {tuple(o.shape)}, dout "
                         f"{tuple(dout.shape)} or lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    dev = q.device
    D = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=out_dtype, device=dev)
    dk = torch.empty(k.shape, dtype=out_dtype, device=dev)
    dv = torch.empty(k.shape, dtype=out_dtype, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.flash_attn_bwd_launch(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
            build.ptr(dout), build.ptr(lse), build.ptr(D), build.ptr(dq),
            build.ptr(dk), build.ptr(dv), b, sq, skv, hq, hkv, hd,
            int(causal), int(q_offset), scale_of(hd, scale),
            int(out_dtype == torch.bfloat16), build.stream_handle(dev))
    build.check_launch(rc, "flash_attn_bwd")
    flash_attn_bwd.launches += 1
    kernel_work("flash_attn_bwd", plain_flops(q, k, True),
                (q, k, v, o, dout, lse, D, dq, dk, dv))
    return dq, dk, dv


flash_attn_fwd.launches = 0
flash_attn_bwd.launches = 0
