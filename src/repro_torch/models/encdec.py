"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Counterpart of ``repro.models.encdec``.  The conv frontend is a stub:
the caller feeds precomputed frame embeddings (b, enc_seq, d_model) to
the encoder.  Encoder: bidirectional self-attention and a tanh-GELU MLP
with LayerNorm (with bias), as in Whisper.  Decoder: causal
self-attention, cross-attention to the encoder states, MLP.  Sinusoidal
absolute positions (no rope).

The params are the reference's tree, key for key: ``enc_layers/{ln1,
attn,ln2,mlp}``, ``enc_norm``, ``tok_embed/table``, ``dec_layers/{ln1,
self_attn,ln2,cross_attn,ln3,mlp}``, ``final_norm`` and
``lm_head/table``, with layer-stacked leaves of shape (n_layers, …).
The reference's ``lax.scan`` over layers is a loop over the stacked
leaves' slices, each layer under ``torch.utils.checkpoint`` in training
(its remat).  Cross-attention reads keys and values of the encoder
output through ``wk``/``wv`` and keeps ``n_kv = n_heads``; the
reference also projects the decoder state through them and drops the
result, which the port does not compute.  The cache is the reference's
``cache_factory`` layout: self ``k``/``v`` (L, b, max_seq, n_kv, hd),
written in place by decode, and cross ``ck``/``cv`` (L, b, enc_seq,
n_heads, hd), written once at prefill.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import layer_slices

Params = Dict[str, Any]

# decode adds row ``pos`` of an 8,192-row position table, its index
# clamped to the last row as the reference's ``dynamic_slice`` clamps it
DECODE_POSITIONS = 8192
_POSITIONS: Dict[Any, torch.Tensor] = {}


def _ln_init(d: int, *, lead=(), device="cuda"):
    lead = tuple(lead)
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros(lead + (d,), dtype=torch.float32,
                                device=device)}


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    return cm.layernorm(x, p["scale"], p["bias"])


def _mlp_init(generator, d: int, f: int, *, lead=(), device="cuda"):
    return {"w1": cm.dense_init(generator, d, f, lead=lead, device=device),
            "w2": cm.dense_init(generator, f, d, lead=lead, device=device)}


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ p["w1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"].to(x.dtype)


def enc_layer_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    d = cfg.d_model
    return {"ln1": _ln_init(d, lead=lead, device=device),
            "attn": attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, lead=lead, device=device),
            "ln2": _ln_init(d, lead=lead, device=device),
            "mlp": _mlp_init(generator, d, cfg.d_ff, lead=lead,
                             device=device)}


def dec_layer_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    d = cfg.d_model
    return {"ln1": _ln_init(d, lead=lead, device=device),
            "self_attn": attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv,
                                        cfg.head_dim, lead=lead,
                                        device=device),
            "ln2": _ln_init(d, lead=lead, device=device),
            "cross_attn": attn.attn_init(generator, d, cfg.n_heads,
                                         cfg.n_heads, cfg.head_dim,
                                         lead=lead, device=device),
            "ln3": _ln_init(d, lead=lead, device=device),
            "mlp": _mlp_init(generator, d, cfg.d_ff, lead=lead,
                             device=device)}


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The reference's params tree, drawn from ``generator`` on ``device``
    (default: the generator's, or the card without one); on the ``meta``
    device it allocates nothing."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    # drawn in this order: the encoder, the decoder, the two tables
    enc = enc_layer_init(generator, cfg, lead=(cfg.enc_layers,),
                         device=device)
    dec = dec_layer_init(generator, cfg, lead=(cfg.n_layers,), device=device)
    return {"enc_layers": enc,
            "enc_norm": _ln_init(cfg.d_model, device=device),
            "tok_embed": {"table": cm.embed_init(generator, cfg.vocab,
                                                 cfg.d_model, device=device)},
            "dec_layers": dec,
            "final_norm": _ln_init(cfg.d_model, device=device),
            "lm_head": {"table": cm.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device=device)}}


def _run_layers(body, layers, x: torch.Tensor, remat: bool) -> torch.Tensor:
    for lp in layer_slices(layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x = body(lp, x)
    return x


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames: (b, enc_seq, d_model) stub embeddings."""
    _b, s, d = frames.shape
    x = frames.to(cfg.dtype) + cm.sinusoidal_positions(
        s, d, frames.device).to(cfg.dtype)

    def body(lp, h):
        a = _ln(h, lp["ln1"])
        q, k, v = attn.attn_qkv(lp["attn"], a, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim)
        h = h + attn.attn_out(lp["attn"], attn.flash_attention(
            q, k, v, False, cfg.attn_chunk))
        return h + _mlp(lp["mlp"], _ln(h, lp["ln2"]))

    x = _run_layers(body, params["enc_layers"], x, remat)
    return _ln(x, params["enc_norm"])


def _cross_kv(cfg: ArchConfig, lp, enc_out: torch.Tensor):
    """Cross-attention keys and values of the encoder output, (b, se,
    n_heads, hd) each."""
    b, se, _ = enc_out.shape
    p = lp["cross_attn"]
    shape = (b, se, cfg.n_heads, cfg.head_dim)
    return ((enc_out @ p["wk"].to(enc_out.dtype)).reshape(shape),
            (enc_out @ p["wv"].to(enc_out.dtype)).reshape(shape))


def _cross_q(cfg: ArchConfig, lp, h: torch.Tensor) -> torch.Tensor:
    b, s, _ = h.shape
    return (h @ lp["cross_attn"]["wq"].to(h.dtype)).reshape(
        b, s, cfg.n_heads, cfg.head_dim)


def _dec_layer_full(cfg: ArchConfig, lp, x: torch.Tensor,
                    enc_out: torch.Tensor, return_cache: bool = False):
    """A decoder layer over the whole sequence (training and prefill);
    with ``return_cache`` also its (k, v, ck, cv)."""
    h = _ln(x, lp["ln1"])
    q, k, v = attn.attn_qkv(lp["self_attn"], h, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim)
    x = x + attn.attn_out(lp["self_attn"], attn.flash_attention(
        q, k, v, True, cfg.attn_chunk))
    cq = _cross_q(cfg, lp, _ln(x, lp["ln2"]))
    ck, cv = _cross_kv(cfg, lp, enc_out)
    x = x + attn.attn_out(lp["cross_attn"], attn.flash_attention(
        cq, ck, cv, False, cfg.attn_chunk))
    x = x + _mlp(lp["mlp"], _ln(x, lp["ln3"]))
    if return_cache:
        return x, (k, v, ck, cv)
    return x


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    s = tokens.shape[1]
    x = params["tok_embed"]["table"].to(cfg.dtype)[tokens.long()]
    return x + cm.sinusoidal_positions(s, cfg.d_model,
                                       x.device).to(cfg.dtype)


def train_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    """batch: frames (b, enc_seq, d), tokens (b, s), labels (b, s)."""
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    x = _embed(cfg, params, batch["tokens"])
    x = _run_layers(lambda lp, h: _dec_layer_full(cfg, lp, h, enc_out),
                    params["dec_layers"], x, remat)
    return cm.head_loss(cfg, _ln(x, params["final_norm"]),
                        params["lm_head"]["table"], batch, sampled_softmax)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device="cuda", enc_seq: Optional[int] = None):
    """Zeroed cache: self ``k``/``v`` (L, batch, max_seq, n_kv, hd), cross
    ``ck``/``cv`` (L, batch, enc_seq, n_heads, hd) (``enc_seq`` defaults
    to the config's), and ``len``, the filled length, a host int32
    scalar."""
    dtype = dtype or cfg.dtype
    L, hd = cfg.n_layers, cfg.head_dim
    self_shape = (L, batch, max_seq, cfg.n_kv, hd)
    cross_shape = (L, batch, enc_seq or cfg.enc_seq, cfg.n_heads, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "ck": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cv": torch.zeros(cross_shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32)}


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    x = _ln(x, params["final_norm"])
    return (x @ params["lm_head"]["table"].to(cfg.dtype).T)[:, 0]


def prefill(cfg: ArchConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor, max_seq: Optional[int] = None):
    """Returns (last-position logits (b, vocab), cache): the self cache
    holds the s prompt positions, the cross cache the encoder's."""
    enc_out = encode(cfg, params, frames)
    b, s = tokens.shape
    max_seq = max_seq or s
    x = _embed(cfg, params, tokens)
    cache = init_cache(cfg, b, max_seq, device=x.device,
                       enc_seq=enc_out.shape[1])
    for i, lp in enumerate(layer_slices(params["dec_layers"])):
        x, (k, v, ck, cv) = _dec_layer_full(cfg, lp, x, enc_out,
                                            return_cache=True)
        cache["k"][i, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :s] = v.to(cfg.dtype)
        cache["ck"][i] = ck.to(cfg.dtype)
        cache["cv"][i] = cv.to(cfg.dtype)
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return _logits(cfg, params, x[:, -1:]), cache


def _position_row(pos: int, d: int, device) -> torch.Tensor:
    """Row ``pos`` (clamped to the table) of the decode position table,
    the table formed once a (d, device)."""
    key = (d, torch.device(device))
    if key not in _POSITIONS:
        _POSITIONS[key] = cm.sinusoidal_positions(DECODE_POSITIONS, d,
                                                  device)
    return _POSITIONS[key][min(max(pos, 0), DECODE_POSITIONS - 1)]


def decode_step(cfg: ArchConfig, params: Params, cache, token: torch.Tensor):
    """token (b,) int32.  Returns (logits (b, vocab), cache'): the new
    token's k and v are written into the self cache IN PLACE and ``len``
    advances by one; the cross cache is read only."""
    pos = int(cache["len"])
    x = params["tok_embed"]["table"].to(cfg.dtype)[token.long()[:, None]]
    x = x + _position_row(pos, cfg.d_model, x.device).to(cfg.dtype)
    for i, lp in enumerate(layer_slices(params["dec_layers"])):
        ck, cv = cache["k"][i], cache["v"][i]
        a = _ln(x, lp["ln1"])
        q, k, v = attn.attn_qkv(lp["self_attn"], a, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim)
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        x = x + attn.attn_out(lp["self_attn"],
                              attn.decode_attention(q, ck, cv, pos + 1))
        cq = _cross_q(cfg, lp, _ln(x, lp["ln2"]))
        ckx, cvx = cache["ck"][i], cache["cv"][i]
        x = x + attn.attn_out(lp["cross_attn"], attn.decode_attention(
            cq, ckx, cvx, ckx.shape[1]))
        x = x + _mlp(lp["mlp"], _ln(x, lp["ln3"]))
    return _logits(cfg, params, x), {
        "k": cache["k"], "v": cache["v"], "ck": cache["ck"],
        "cv": cache["cv"], "len": torch.tensor(pos + 1, dtype=torch.int32)}
