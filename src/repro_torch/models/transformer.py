"""Decoder-only LM, the dense GQA family (internlm2 / yi / granite /
qwen2).

Counterpart of the ``gqa`` half of ``repro.models.transformer``.  The
params are the reference's tree, key for key: ``tok_embed/table``,
``layers/...`` with layer-stacked leaves of shape (n_layers, …),
``final_norm`` and ``lm_head/table`` (two vocabulary tables, whatever
``tie_embeddings`` says), so sketch policies, plans and checkpoint leaf
paths match the reference's strings.  The reference's ``lax.scan`` over
layers is a loop over the stacked leaves' slices (``unbind``: one
gradient ``stack`` a leaf, not one full-size buffer a layer); training
runs each layer under ``torch.utils.checkpoint`` (the reference's
remat).  The KV cache is written in place.

The MoE family (``uses_blocks``, ``moe``) waits for ROADMAP A14b.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.partition import leaf_paths
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "gqa":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP A14b); "
            f"the port's transformer runs the dense 'gqa' family")


def uses_blocks(cfg: ArchConfig) -> bool:
    if cfg.family == "moe":
        raise NotImplementedError(
            "interleaved MoE blocks are not ported yet (ROADMAP A14b)")
    return False


def n_scan_units(cfg: ArchConfig) -> int:
    _dense_only(cfg)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _ffn_apply(cfg: ArchConfig, p, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss)."""
    dt = x.dtype
    gate = x @ p["w_gate"].to(dt)
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate,
                                                         approximate="tanh")
    h = act * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def layer_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """One layer's params; ``lead`` = (n_layers,) stacks them."""
    _dense_only(cfg)
    lead = tuple(lead)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln1": torch.ones(lead + (d,), dtype=torch.float32, device=device),
        "attn": attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv,
                               cfg.head_dim, cfg.qkv_bias, lead=lead,
                               device=device),
        "ln2": torch.ones(lead + (d,), dtype=torch.float32, device=device),
        "ffn": {"w_gate": cm.dense_init(generator, d, f, lead=lead,
                                        device=device),
                "w_up": cm.dense_init(generator, d, f, lead=lead,
                                      device=device),
                "w_down": cm.dense_init(generator, f, d, lead=lead,
                                        device=device)},
    }


def _attention(cfg: ArchConfig, q, k, v):
    """Causal flash attention, KV heads replicated up to hq under
    ``cfg.repeat_kv`` (the reference's tensor-parallel layout)."""
    if cfg.repeat_kv and cfg.n_heads != cfg.n_kv:
        g = cfg.n_heads // cfg.n_kv
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return attn.flash_attention(q, k, v, True, cfg.attn_chunk)


def _layer_core(cfg: ArchConfig, p, x, positions):
    h = cm.rmsnorm(x, p["ln1"])
    q, k, v = attn.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    x = x + attn.attn_out(p["attn"], _attention(cfg, q, k, v))
    f, aux = _ffn_apply(cfg, p["ffn"], cm.rmsnorm(x, p["ln2"]))
    return x + f, aux, (k, v)


def layer_apply_train(cfg: ArchConfig, p, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    x, aux, _ = _layer_core(cfg, p, x, positions)
    return x, aux


def layer_prefill(cfg: ArchConfig, p, x: torch.Tensor,
                  positions: torch.Tensor):
    """Like train but returns the (k, v) cache for this layer."""
    x, _, kv = _layer_core(cfg, p, x, positions)
    return x, kv


def layer_decode(cfg: ArchConfig, p, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, pos: int):
    """x (b,1,d); ck/cv (b,S,hkv,hd), written IN PLACE at ``pos`` (the
    current length, a host int)."""
    h = cm.rmsnorm(x, p["ln1"])
    q, k, v = attn.attn_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = cm.apply_rope(q, posv, cfg.rope_theta)
    k = cm.apply_rope(k, posv, cfg.rope_theta)
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    o = attn.decode_attention(q, ck, cv, pos + 1)
    x = x + attn.attn_out(p["attn"], o)
    f, _ = _ffn_apply(cfg, p["ffn"], cm.rmsnorm(x, p["ln2"]))
    return x + f, ck, cv


def layer_slices(layers) -> List[Dict[str, Any]]:
    """The stacked layer tree as one tree of (…) views a layer
    (``unbind`` along axis 0)."""
    flat = [(path, leaf.unbind(0)) for path, leaf in leaf_paths(layers)]
    n = len(flat[0][1])
    out = []
    for i in range(n):
        tree: Dict[str, Any] = {}
        for path, parts in flat:
            node = tree
            keys = path.split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = parts[i]
        out.append(tree)
    return out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The reference's params tree, drawn from ``generator`` (f32 master
    weights at the reference's scales) on ``device`` (default: the
    generator's, or the card without one).  On the ``meta`` device it
    allocates nothing (shapes for the planner)."""
    _dense_only(cfg)
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return {
        "tok_embed": {"table": cm.embed_init(generator, cfg.vocab,
                                             cfg.d_model, device=device)},
        "layers": layer_init(generator, cfg, lead=(cfg.n_layers,),
                             device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
        "lm_head": {"table": cm.embed_init(generator, cfg.vocab,
                                           cfg.d_model, device=device)},
    }


def backbone_train(cfg: ArchConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, remat: bool = True):
    """Run the layer stack; x (b,s,d).  Returns (x, total_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(lp, h):
        return layer_apply_train(cfg, lp, h, positions)

    for lp in layer_slices(params["layers"]):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x, a = body(lp, x)
        aux = aux + a
    return x, aux


def embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["tok_embed"]["table"].to(cfg.dtype)[tokens.long()]


def logits_fn(cfg: ArchConfig, params: Params, x: torch.Tensor
              ) -> torch.Tensor:
    x = cm.rmsnorm(x, params["final_norm"])
    return x @ params["lm_head"]["table"].to(cfg.dtype).T


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.arange(s, device=device), (b, s))


def train_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    x = embed(cfg, params, tokens)
    x, aux = backbone_train(cfg, params, x, _positions(b, s, x.device),
                            remat=remat)
    x = cm.rmsnorm(x, params["final_norm"])
    if sampled_softmax:
        loss = cm.sampled_softmax_xent(
            x.reshape(b * s, -1), params["lm_head"]["table"],
            labels.reshape(-1), batch["neg_ids"])
    else:
        loss = cm.chunked_softmax_xent(
            x, params["lm_head"]["table"], labels, cfg.loss_chunk)
    return loss + 0.01 * aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Zeroed KV cache: ``k``/``v`` (n_layers, batch, max_seq, n_kv,
    head_dim) and ``len``, the filled length, a host int32 scalar."""
    dtype = dtype or cfg.dtype
    shape = (n_scan_units(cfg), batch, max_seq, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32)}


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_seq: Optional[int] = None):
    """Returns (last-position logits (b, vocab), cache)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    x = embed(cfg, params, tokens)
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_seq, device=x.device)
    for i, lp in enumerate(layer_slices(params["layers"])):
        x, (k, v) = layer_prefill(cfg, lp, x, positions)
        cache["k"][i, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :s] = v.to(cfg.dtype)
    logits = logits_fn(cfg, params, x[:, -1:])[:, 0]
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return logits, cache


def decode_step(cfg: ArchConfig, params: Params, cache, token: torch.Tensor):
    """token (b,) int32.  Returns (logits (b, vocab), cache'): the new
    token's k and v are written into ``cache``'s tensors IN PLACE and
    ``len`` advances by one."""
    x = embed(cfg, params, token[:, None])
    pos = int(cache["len"])
    for i, lp in enumerate(layer_slices(params["layers"])):
        x, _, _ = layer_decode(cfg, lp, x, cache["k"][i], cache["v"][i], pos)
    logits = logits_fn(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": torch.tensor(pos + 1, dtype=torch.int32)}
