"""GraniteMoeHybrid (granite-4.0-h): Mamba2 and NoPE attention mixers,
each layer followed by a dropless mixture of experts and a shared
SwiGLU expert.  The ``hybrid_moe`` family; the reference package has no
counterpart.

Per layer i, its mixer Mamba2 or attention as ``cfg.layer_types[i]``
says, and m = ``cfg.residual_multiplier``:

    h  = x + m·mixer(rmsnorm(x))
    x' = h + m·(moe(rmsnorm(h)) + shared(rmsnorm(h)))

The Mamba2 mixer is ``mamba.mamba_mixer`` (under ``mamba_gate_first``
its gated norm is ``rmsnorm(y·silu(z))``, as Granite's).  Attention is
GQA with no position embedding (NoPE, as every GraniteMoeHybrid
attention layer: the family applies no RoPE) and the softmax scale
``attention_multiplier``.  The
MoE is ``moe.held_moe_apply``: the router over all experts, the part of
the result that the experts this device holds give, and the shared
expert.  The stack starts from the embedding times
``embedding_multiplier`` and ends with the final RMSNorm and the head's
logits over ``logits_scaling``; the loss is the cross-entropy alone (the
published configuration sets no router loss).  Every norm takes
``cfg.norm_eps``.

Params: ``tok_embed/table``; ``layers/mamba/*`` stacked over the Mamba2
layers (``mamba.mamba_init``'s leaves, ``ln`` the mixer's norm);
``layers/attn/*`` (``ln``, ``wq``, ``wk``, ``wv``, ``wo``) stacked over
the attention layers; ``layers/ffn/*`` (``ln``, ``router``, the held
experts' ``w_gate``/``w_up``/``w_down``, ``shared/*``) stacked over all
layers; ``final_norm``; ``lm_head/table`` (two vocabulary tables where
the published model ties them, as the other families build them).
Training runs each layer under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mamba
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
MIXERS = ("mamba", "attention")


def layer_types(cfg: ArchConfig) -> List[str]:
    """The mixer of each of the ``n_layers`` layers."""
    types = list(cfg.layer_types[:cfg.n_layers])
    if len(types) != cfg.n_layers or not set(types) <= set(MIXERS):
        raise ValueError(f"{cfg.name}: layer_types {cfg.layer_types!r} "
                         f"does not give {MIXERS} mixers for "
                         f"{cfg.n_layers} layers")
    return types


def _ones(lead, d, device):
    return torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                      device=device)


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The params tree, drawn from ``generator`` on ``device`` (default:
    the generator's, or the card without one); on the ``meta`` device it
    allocates nothing."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    types = layer_types(cfg)
    n_mamba, n_attn = types.count("mamba"), types.count("attention")
    d = cfg.d_model
    # drawn in this order: the embedding, the Mamba2 mixers, the
    # attention mixers, the MoE layers, the head
    tok_embed = cm.embed_init(generator, cfg.vocab, d, device=device)
    layers = {}
    if n_mamba:
        layers["mamba"] = mamba.mamba_init(generator, cfg, lead=(n_mamba,),
                                           device=device)
    if n_attn:
        layers["attn"] = dict(
            ln=_ones((n_attn,), d, device),
            **attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv,
                             cfg.head_dim, lead=(n_attn,), device=device))
    layers["ffn"] = dict(
        ln=_ones((cfg.n_layers,), d, device),
        **moe.held_moe_init(generator, cfg, lead=(cfg.n_layers,),
                            device=device))
    return {"tok_embed": {"table": tok_embed},
            "layers": layers,
            "final_norm": _ones((), d, device),
            "lm_head": {"table": cm.embed_init(generator, cfg.vocab, d,
                                               device=device)}}


def _attention(cfg: ArchConfig, p, h: torch.Tensor) -> torch.Tensor:
    q, k, v = attn.attn_qkv(p, h, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    o = attn.flash_attention(q, k, v, True, cfg.attn_chunk,
                             scale=cfg.attention_multiplier or None)
    return attn.attn_out(p, o)


def _layer(cfg: ArchConfig, kind: str, mp, fp, x: torch.Tensor
           ) -> torch.Tensor:
    m = cfg.residual_multiplier
    hn = cm.rmsnorm(x, mp["ln"], cfg.norm_eps)
    if kind == "mamba":
        zero = {k: v[0] for k, v in mamba.mamba_zero_state(
            cfg, x.shape[0], 1, device=x.device).items()}
        out = mamba.mamba_mixer(cfg, mp, hn, zero, "chunked")[0]
    else:
        out = _attention(cfg, mp, hn)
    h = x + out * m
    return h + moe.held_moe_apply(cfg, fp, cm.rmsnorm(h, fp["ln"],
                                                      cfg.norm_eps)) * m


def train_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    x = tf.embed(cfg, params, batch["tokens"]) * cfg.embedding_multiplier
    lay = params["layers"]
    mixers = {"mamba": iter(tf.layer_slices(lay["mamba"]))
              if "mamba" in lay else iter(()),
              "attention": iter(tf.layer_slices(lay["attn"]))
              if "attn" in lay else iter(())}
    ckpt = remat and torch.is_grad_enabled()
    for kind, fp in zip(layer_types(cfg), tf.layer_slices(lay["ffn"])):
        mp = next(mixers[kind])
        x = checkpoint(_layer, cfg, kind, mp, fp, x, use_reentrant=False) \
            if ckpt else _layer(cfg, kind, mp, fp, x)
    return cm.head_loss(cfg, cm.rmsnorm(x, params["final_norm"],
                                        cfg.norm_eps),
                        params["lm_head"]["table"], batch, sampled_softmax)
