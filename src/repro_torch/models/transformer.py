"""Decoder-only LM: dense GQA (internlm2 / yi / granite / qwen2) and the
MoE variants (qwen2-moe / llama4-maverick).

Counterpart of ``repro.models.transformer``.  The params are the
reference's tree, key for key: ``tok_embed/table``, ``layers/...`` with
layer-stacked leaves of shape (n_layers, …), ``final_norm`` and
``lm_head/table`` (two vocabulary tables, whatever ``tie_embeddings``
says), so sketch policies, plans and checkpoint leaf paths match the
reference's strings.  ``moe_every == 2`` (llama4-maverick) interleaves
dense-FFN and MoE layers as the reference does: the stacked unit is a
``{"dense", "moe"}`` block of n_layers / 2 units, and the KV cache
gains a block axis, (units, 2, b, s, kv, hd).  The reference's
``lax.scan`` over units is a loop over the stacked leaves' slices
(``unbind``: one gradient ``stack`` a leaf, not one full-size buffer a
unit); training runs each unit under ``torch.utils.checkpoint`` (the
reference's remat).  The KV cache is written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.partition import leaf_paths
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("gqa", "moe", "vlm"):
        raise NotImplementedError(
            f"the transformer does not run the {cfg.family!r} family; "
            f"it runs the 'gqa' and 'moe' families and the VLM's text "
            f"backbone (train.steps.family_module gives each family's "
            f"module)")


def uses_blocks(cfg: ArchConfig) -> bool:
    return cfg.family == "moe" and cfg.moe_every > 1


def _dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """The interleaved dense layer's view of the config."""
    return dataclasses.replace(cfg, family="gqa",
                               d_ff=cfg.dense_d_ff or cfg.d_ff)


def n_scan_units(cfg: ArchConfig) -> int:
    _ported(cfg)
    if uses_blocks(cfg):
        assert cfg.moe_every == 2, "only moe_every in (1, 2) is implemented"
        assert cfg.n_layers % 2 == 0
        return cfg.n_layers // 2
    return cfg.n_layers


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _ffn_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    if cfg.family == "moe":
        return moe_lib.moe_init(generator, cfg, lead=lead, device=device)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": cm.dense_init(generator, d, f, lead=lead,
                                    device=device),
            "w_up": cm.dense_init(generator, d, f, lead=lead, device=device),
            "w_down": cm.dense_init(generator, f, d, lead=lead,
                                    device=device)}


def _ffn_apply(cfg: ArchConfig, p, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss)."""
    if cfg.family == "moe":
        b, s, d = x.shape
        y, aux = moe_lib.moe_apply(cfg, p, x.reshape(b * s, d))
        return y.reshape(b, s, d), aux
    dt = x.dtype
    gate = x @ p["w_gate"].to(dt)
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate,
                                                         approximate="tanh")
    h = act * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def layer_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """One layer's params; ``lead`` = (n_layers,) stacks them."""
    _ported(cfg)
    lead = tuple(lead)
    d = cfg.d_model
    return {
        "ln1": torch.ones(lead + (d,), dtype=torch.float32, device=device),
        "attn": attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv,
                               cfg.head_dim, cfg.qkv_bias, lead=lead,
                               device=device),
        "ln2": torch.ones(lead + (d,), dtype=torch.float32, device=device),
        "ffn": _ffn_init(generator, cfg, lead=lead, device=device),
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

def _unit_parts(cfg: ArchConfig):
    """``[(cfg, key)]`` of one stacked unit: ``[(dense view, "dense"),
    (cfg, "moe")]`` for a block, ``[(cfg, None)]`` for a plain layer."""
    if uses_blocks(cfg):
        return [(_dense_cfg(cfg), "dense"), (cfg, "moe")]
    return [(cfg, None)]


def _parts(cfg: ArchConfig, unit):
    """``(sub-config, layer params, block index)`` of each layer of one
    unit's params."""
    return [(c, unit if key is None else unit[key], None if key is None
             else j) for j, (c, key) in enumerate(_unit_parts(cfg))]


def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The reference's params tree, drawn from ``generator`` (f32 master
    weights at the reference's scales) on ``device`` (default: the
    generator's, or the card without one).  On the ``meta`` device it
    allocates nothing (shapes for the planner)."""
    _ported(cfg)
    if device is None:
        device = generator.device if generator is not None else "cuda"
    lead = (n_scan_units(cfg),)
    # drawn in this order: the embedding, the layers, the head
    tok_embed = cm.embed_init(generator, cfg.vocab, cfg.d_model,
                              device=device)
    if uses_blocks(cfg):
        layers = {key: layer_init(generator, c, lead=lead, device=device)
                  for c, key in _unit_parts(cfg)}
    else:
        layers = layer_init(generator, cfg, lead=lead, device=device)
    return {
        "tok_embed": {"table": tok_embed},
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
        "lm_head": {"table": cm.embed_init(generator, cfg.vocab,
                                           cfg.d_model, device=device)},
    }


def backbone_train(cfg: ArchConfig, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, remat: bool = True):
    """Run the layer stack; x (b,s,d).  Returns (x, total_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(unit, h):
        a = torch.zeros((), dtype=torch.float32, device=h.device)
        for c, lp, _ in _parts(cfg, unit):
            h, a_l = layer_apply_train(c, lp, h, positions)
            a = a + a_l
        return h, a

    for unit in layer_slices(params["layers"]):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, unit, x, use_reentrant=False)
        else:
            x, a = body(unit, x)
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
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(cfg, params, tokens)
    x, aux = backbone_train(cfg, params, x, _positions(b, s, x.device),
                            remat=remat)
    loss = cm.head_loss(cfg, cm.rmsnorm(x, params["final_norm"]),
                        params["lm_head"]["table"], batch, sampled_softmax)
    return loss + 0.01 * aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Zeroed KV cache: ``k``/``v`` (units, [2,] batch, max_seq, n_kv,
    head_dim), the block axis under ``uses_blocks``, and ``len``, the
    filled length, a host int32 scalar."""
    dtype = dtype or cfg.dtype
    sub = (2,) if uses_blocks(cfg) else ()
    shape = (n_scan_units(cfg),) + sub + (batch, max_seq, cfg.n_kv,
                                          cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32)}


def _at(c: torch.Tensor, i: int, j: Optional[int]) -> torch.Tensor:
    """Unit ``i``'s (block ``j``'s) slice of a cache tensor, a view."""
    return c[i] if j is None else c[i, j]


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_seq: Optional[int] = None):
    """Returns (last-position logits (b, vocab), cache)."""
    return prefill_embedded(cfg, params, embed(cfg, params, tokens), max_seq)


def prefill_embedded(cfg: ArchConfig, params: Params, x: torch.Tensor,
                     max_seq: Optional[int] = None):
    """``prefill`` of the embedded sequence x (b, s, d) at positions
    0..s-1 (the VLM's patches and text)."""
    b, s, _ = x.shape
    max_seq = max_seq or s
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_seq, device=x.device)
    for i, unit in enumerate(layer_slices(params["layers"])):
        for c, lp, j in _parts(cfg, unit):
            x, (k, v) = layer_prefill(c, lp, x, positions)
            _at(cache["k"], i, j)[:, :s] = k.to(cfg.dtype)
            _at(cache["v"], i, j)[:, :s] = v.to(cfg.dtype)
    logits = logits_fn(cfg, params, x[:, -1:])[:, 0]
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return logits, cache


def decode_step(cfg: ArchConfig, params: Params, cache, token: torch.Tensor):
    """token (b,) int32.  Returns (logits (b, vocab), cache'): the new
    token's k and v are written into ``cache``'s tensors IN PLACE and
    ``len`` advances by one."""
    x = embed(cfg, params, token[:, None])
    pos = int(cache["len"])
    for i, unit in enumerate(layer_slices(params["layers"])):
        for c, lp, j in _parts(cfg, unit):
            x, _, _ = layer_decode(c, lp, x, _at(cache["k"], i, j),
                                   _at(cache["v"], i, j), pos)
    logits = logits_fn(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": torch.tensor(pos + 1, dtype=torch.int32)}
