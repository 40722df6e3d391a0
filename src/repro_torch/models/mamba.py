"""Mamba2 (SSD, a scalar decay a head) blocks and the Zamba2 hybrid stack.

Counterpart of ``repro.models.mamba``.  The SSD recurrence per head
(state h of (p, n), p the head dim, n = ssm_state):

    h_t = exp(a·dt_t)·h_{t-1} + dt_t·x_t ⊗ B_t
    y_t = h_t·C_t + D·x_t

Training and prefill take the chunked form (chunk = ``cfg.rwkv_chunk``,
as in the reference) when the length is a multiple of the chunk, else
the sequential ``ssd_scan``.  As in ``rwkv``, the port forms every
chunk's intra-chunk terms at once and loops over the chunks only for
the state.  The reference's einsums take compute-dtype operands with
f32 accumulation and round the decay matrix ``M`` and the weights ``w``
to the compute dtype before the product; the port rounds them where the
reference does and multiplies the f32 upcasts (exact products, f32
sums).  Above the diagonal the decay differences are positive: the
reference takes their ``exp`` and masks it after, so once a chunk's
log-decays sum below about −88.7 the exp overflows f32 and its backward
is 0·inf = NaN (zamba2-2.7b from its init on 4 × 2,048 ZipfLM tokens:
the loss NaN from the second step).  The port zeroes those exponents before
the exp: every value of the forward is the reference's, and so is the
gradient wherever the reference's is finite (ROADMAP C).

Zamba2: Mamba2 layers with ONE weight-shared attention+MLP block (the
transformer's layer under ``_shared_cfg``: family ``gqa``, head_dim
d_model / n_heads) before every ``attn_every`` layers.  Its KV cache is
per site (weights shared, cache not): ``attn_k``/``attn_v`` (sites, b,
max_seq, n_kv, head_dim), written in place.  Training runs a group (the
shared block and its mamba layers) under ``torch.utils.checkpoint`` and
each mamba layer under another, the reference's nested remat.  The
causal conv (kernel 4) is a sum of shifted slices in the reference's
order.  The reference's ``shard_act`` constraints are ``cm.shard_act``,
the identity on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.obs.profiling import scope

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _ssd_step(h, x_t, dt_t, la_t, B_t, C_t):
    x_t, B_t, C_t = (t.to(torch.float32) for t in (x_t, B_t, C_t))
    h = torch.exp(la_t)[..., None, None] * h + \
        (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]
    return h, torch.einsum("bhpn,bn->bhp", h, C_t)


def ssd_scan(x, dt, la, B, C, h0):
    """Oracle.  x (b,s,h,p); dt, la (b,s,h); B, C (b,s,n); h0 (b,h,p,n).
    Returns (y (b,s,h,p) f32, h_final)."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        h, y = _ssd_step(h, x[:, t], dt[:, t], la[:, t], B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, la, B, C, h0, chunk: int):
    """Chunked form; shapes as in ``ssd_scan``.  Falls back to the scan
    when ``chunk`` does not divide the length."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        return ssd_scan(x, dt, la, B, C, h0)
    L, nc = chunk, s // chunk
    f32 = torch.float32
    xb = x.reshape(b, nc, L, h, p)
    Bb = B.reshape(b, nc, L, n)
    Cb = C.reshape(b, nc, L, n)
    # heads ahead of the chunk's positions: (b, c, h, L) and the (L, L)
    # matrices last, so the masks are ``tril`` and the products batched
    # matmuls without a transposed copy
    dtT = dt.reshape(b, nc, L, h).transpose(2, 3)
    laI = torch.cumsum(la.reshape(b, nc, L, h).to(f32).transpose(2, 3),
                       dim=3)                                   # (b,c,h,L)
    # intra-chunk: M[i, j] = exp(laI_i − laI_j)·(C_i·B_j)·dt_j, j ≤ i.
    # Above the diagonal the exponents are positive and may overflow:
    # they are zeroed before the exp (see the module docstring)
    dec = (laI[..., :, None] - laI[..., None, :]).tril()       # (b,c,h,i,j)
    cb = torch.einsum("bcin,bcjn->bcij", Cb.to(f32), Bb.to(f32))
    M = (torch.exp(dec) * (cb[:, :, None] * dtT[..., None, :])).tril()
    # M rounded to x's dtype, then exact products summed in f32
    xT = xb.transpose(2, 3).to(f32)                             # (b,c,h,L,p)
    y = M.to(x.dtype).to(f32) @ xT                              # (b,c,h,i,p)
    # the state update's terms: w rounded to x's dtype, w·x in x's dtype
    la_tot = laI[..., -1:]                                      # (b,c,h,1)
    w = torch.exp(la_tot - laI) * dtT                           # f32
    wx = (w.to(x.dtype)[..., None] * xb.transpose(2, 3)).to(f32)
    upd = wx.transpose(3, 4) @ Bb.to(f32)[:, :, None]          # (b,c,h,p,n)
    decay = torch.exp(la_tot)[..., None]                        # (b,c,h,1,1)
    hs, before = h0, []
    for c in range(nc):
        before.append(hs)
        hs = decay[:, c] * hs + upd[:, c]
    # inter-chunk: y_i += exp(laI_i)·C_i·h (the state before the chunk)
    y = y + torch.exp(laI)[..., None] * (
        Cb.to(f32)[:, :, None] @ torch.stack(before, dim=1).transpose(3, 4))
    y = y.transpose(2, 3)                                       # (b,c,L,h,p)
    return y.reshape(b, s, h, p), hs


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """The projections stay separate (z / x / BC / dt), as in the
    reference; so does the depthwise causal conv of each stream.
    ``lead`` = (n_layers,) stacks the layers."""
    lead = tuple(lead)
    d, di, n, hds = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, \
        cfg.ssm_heads
    K = cfg.conv_kernel

    def const(value, size):
        return torch.full(lead + (size,), value, dtype=torch.float32,
                          device=device)

    def dense(d_in, d_out):
        return cm.dense_init(generator, d_in, d_out, lead=lead,
                             device=device)

    # drawn in this order: z, x, bc, dt, the two convs, out
    z, xp, bc, dtp = dense(d, di), dense(d, di), dense(d, 2 * n), \
        dense(d, hds)
    conv_x = cm.normal(generator, lead + (K, di), device, 0.2)
    conv_bc = cm.normal(generator, lead + (K, 2 * n), device, 0.2)
    return {
        "ln": const(1.0, d),
        "z_proj": z, "x_proj": xp, "bc_proj": bc, "dt_proj": dtp,
        "conv_w_x": conv_x, "conv_b_x": const(0.0, di),
        "conv_w_bc": conv_bc, "conv_b_bc": const(0.0, 2 * n),
        "A_log": const(0.0, hds), "dt_bias": const(0.0, hds),
        "D": const(1.0, hds), "gn": const(1.0, di),
        "out_proj": dense(di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv as a sum of shifts.  x (b,s,ch); w (K,ch);
    prev (b,K-1,ch) left context.  Returns (silu(y), new_prev in f32)."""
    K = w.shape[0]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)      # (b, s+K-1, ch)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[K - 1 - i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    return F.silu(y), xp[:, -(K - 1):].to(torch.float32)


def mamba_apply(cfg: ArchConfig, p, x: torch.Tensor, state, mode: str):
    """x (b,s,d); state dict(conv_x (b,K-1,di), conv_bc (b,K-1,2n), h
    (b,heads,p,n)).  Returns (x', state'): the residual stream plus the
    mixer of its RMSNorm (``p["ln"]``)."""
    h_in = cm.shard_act(cm.rmsnorm(x, p["ln"]), None, None)
    out, state = mamba_mixer(cfg, p, h_in, state, mode)
    return x + out, state


def mamba_mixer(cfg: ArchConfig, p, h_in: torch.Tensor, state, mode: str):
    """The Mamba2 mixer of the normed input h_in (b,s,d), in the span
    ``obs.mamba`` (its SSD in ``obs.ssd``): the projections, the causal
    convs, the SSD, the gated RMSNorm (``p["gn"]``: the norm first, then
    the gate ``silu(z)``; gate first under ``cfg.mamba_gate_first``, as
    the published Mamba2 and Granite layers order it) and the output
    projection.  Returns (out (b,s,d), state')."""
    with scope("obs.mamba"):
        return _mixer(cfg, p, h_in, state, mode)


def _mixer(cfg: ArchConfig, p, h_in: torch.Tensor, state, mode: str):
    b, s, _d = h_in.shape
    di, n, hds, hp = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim)
    dt_ = h_in.dtype
    f32 = torch.float32
    z = h_in @ p["z_proj"].to(dt_)
    xr = h_in @ p["x_proj"].to(dt_)
    bc = h_in @ p["bc_proj"].to(dt_)
    dt_raw = h_in @ p["dt_proj"].to(dt_)

    xr, conv_x = _causal_conv(xr, p["conv_w_x"], p["conv_b_x"],
                              state["conv_x"])
    bc, conv_bc = _causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"],
                               state["conv_bc"])
    xs = cm.shard_act(xr.reshape(b, s, hds, hp), None, "model", None)
    B = bc[..., :n]
    C = bc[..., n:]

    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])             # (b,s,h)
    dt = cm.shard_act(dt, None, "model")
    la = -torch.exp(p["A_log"])[None, None] * dt                # ≤ 0

    with scope("obs.ssd"):
        if mode == "chunked":
            y, h_state = ssd_chunked(xs, dt, la, B, C, state["h"],
                                     cfg.rwkv_chunk)
        else:
            y, h_state = ssd_scan(xs, dt, la, B, C, state["h"])
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = cm.shard_act(y, None, "model", None).reshape(b, s, di)
    if cfg.mamba_gate_first:
        y = cm.rmsnorm(y * F.silu(z.to(f32)), p["gn"], cfg.norm_eps)
    else:
        y = cm.rmsnorm(y, p["gn"]) * F.silu(z.to(f32))
    out = cm.shard_act(y.to(dt_) @ p["out_proj"].to(dt_), "model", None)
    return out, {"conv_x": conv_x, "conv_bc": conv_bc, "h": h_state}


def mamba_zero_state(cfg: ArchConfig, batch: int, layers: int,
                     device="cuda"):
    """Zeroed mamba state of ``layers`` layers, layer-stacked."""
    K = cfg.conv_kernel

    def zeros(*shape):
        return torch.zeros((layers, batch) + shape, dtype=torch.float32,
                           device=device)

    return {"conv_x": zeros(K - 1, cfg.ssm_d_inner),
            "conv_bc": zeros(K - 1, 2 * cfg.ssm_state),
            "h": zeros(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)}


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack
# ---------------------------------------------------------------------------

def _shared_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, family="gqa",
                               head_dim=cfg.d_model // cfg.n_heads)


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The reference's params tree, drawn from ``generator`` on ``device``
    (default: the generator's, or the card without one); on the ``meta``
    device it allocates nothing."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    # drawn in this order: the embedding, the layers, the shared block,
    # the head
    tok_embed = cm.embed_init(generator, cfg.vocab, cfg.d_model,
                              device=device)
    layers = mamba_init(generator, cfg, lead=(cfg.n_layers,), device=device)
    shared = tf.layer_init(generator, _shared_cfg(cfg), device=device)
    return {"tok_embed": {"table": tok_embed},
            "layers": layers,
            "shared_attn": shared,
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
            "lm_head": {"table": cm.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device=device)}}


def n_attn_sites(cfg: ArchConfig) -> int:
    assert cfg.n_layers % cfg.attn_every == 0, "attn_every must divide layers"
    return cfg.n_layers // cfg.attn_every


def _group_tree(cfg: ArchConfig, layers):
    """The layer slices (``transformer.layer_slices``) as ``sites`` lists
    of ``attn_every``."""
    flat = tf.layer_slices(layers)
    e = cfg.attn_every
    return [flat[g * e:(g + 1) * e] for g in range(n_attn_sites(cfg))]


def _run_train(cfg: ArchConfig, params: Params, x: torch.Tensor,
               remat: bool = True) -> torch.Tensor:
    """One group = the shared attention block, then ``attn_every`` mamba
    layers from a zero state; under remat each group and each of its
    layers run under ``torch.utils.checkpoint``."""
    b, s, _ = x.shape
    positions = tf._positions(b, s, x.device)
    scfg = _shared_cfg(cfg)
    zero = {k: v[0] for k, v in mamba_zero_state(cfg, b, 1,
                                                  device=x.device).items()}
    ckpt = remat and torch.is_grad_enabled()

    def inner(lp, h):
        return mamba_apply(cfg, lp, h, zero, "chunked")[0]

    def body(glp, h):
        h, _ = tf.layer_apply_train(scfg, params["shared_attn"], h,
                                    positions)
        for lp in glp:
            h = checkpoint(inner, lp, h, use_reentrant=False) if ckpt \
                else inner(lp, h)
        return h

    for glp in _group_tree(cfg, params["layers"]):
        x = checkpoint(body, glp, x, use_reentrant=False) if ckpt \
            else body(glp, x)
    return x


def train_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    x = tf.embed(cfg, params, batch["tokens"])
    x = _run_train(cfg, params, x, remat=remat)
    return cm.head_loss(cfg, cm.rmsnorm(x, params["final_norm"]),
                        params["lm_head"]["table"], batch, sampled_softmax)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Zeroed cache: the layer-stacked ``mamba`` state, the shared
    block's ``attn_k``/``attn_v`` (sites, batch, max_seq, n_kv,
    head_dim) and ``len``, the filled length, a host int32 scalar."""
    dtype = dtype or cfg.dtype
    scfg = _shared_cfg(cfg)
    shape = (n_attn_sites(cfg), batch, max_seq, scfg.n_kv, scfg.head_dim)
    return {"mamba": mamba_zero_state(cfg, batch, cfg.n_layers,
                                      device=device),
            "attn_k": torch.zeros(shape, dtype=dtype, device=device),
            "attn_v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32)}


def _stack_step(cfg: ArchConfig, params: Params, x: torch.Tensor, cache,
                mode: str, positions, pos: Optional[int]) -> torch.Tensor:
    """Shared prefill/decode loop over the groups: the cache's tensors
    (the KV of each site, each layer's mamba state) are written IN
    PLACE."""
    scfg = _shared_cfg(cfg)
    shared = params["shared_attn"]
    mst = cache["mamba"]
    inner_mode = "chunked" if mode == "prefill" else "scan"
    i = 0
    for g, glp in enumerate(_group_tree(cfg, params["layers"])):
        ck, cv = cache["attn_k"][g], cache["attn_v"][g]
        if mode == "prefill":
            x, (k, v) = tf.layer_prefill(scfg, shared, x, positions)
            ck[:, :k.shape[1]] = k.to(ck.dtype)
            cv[:, :v.shape[1]] = v.to(cv.dtype)
        else:
            x, _, _ = tf.layer_decode(scfg, shared, x, ck, cv, pos)
        for lp in glp:
            x, st = mamba_apply(cfg, lp, x, {k: v[i] for k, v in mst.items()},
                                inner_mode)
            for k, v in st.items():
                mst[k][i] = v
            i += 1
    return x


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_seq: Optional[int] = None):
    """Returns (last-position logits (b, vocab), cache)."""
    b, s = tokens.shape
    x = tf.embed(cfg, params, tokens)
    cache = init_cache(cfg, b, max_seq or s, device=x.device)
    x = _stack_step(cfg, params, x, cache, "prefill",
                    tf._positions(b, s, x.device), None)
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return tf.logits_fn(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ArchConfig, params: Params, cache, token: torch.Tensor):
    """token (b,) int32.  Returns (logits (b, vocab), cache'): the cache's
    tensors are written IN PLACE and ``len`` advances by one."""
    x = tf.embed(cfg, params, token[:, None])
    pos = int(cache["len"])
    x = _stack_step(cfg, params, x, cache, "decode", None, pos)
    return tf.logits_fn(cfg, params, x)[:, 0], dict(
        cache, len=torch.tensor(pos + 1, dtype=torch.int32))
