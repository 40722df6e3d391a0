"""RWKV-6 ("Finch"): attention-free, data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv``.  The recurrence per head (k-dim K,
v-dim V, state S of (K, V)):

    wkv_t = (diag(u)·k_t)·v_tᵀ + S_t
    out_t = r_tᵀ · wkv_t
    S_{t+1} = diag(w_t)·S_t + k_t·v_tᵀ          w_t = exp(−exp(x·lora))

Training and prefill take the chunked form (chunk = ``cfg.rwkv_chunk``)
when the length is a multiple of the chunk, else the sequential
``wkv_scan``; decode is one exact step (``wkv_step``).  Within a chunk
the pairwise decays factor into ``(r ⊙ exp(lwX)) @ (k ⊙ exp(−lwI))ᵀ``
(lwX/lwI the exclusive/inclusive cumulative log-decays).  The port
forms every chunk's intra-chunk terms at once and loops over the chunks
only for the state; each output element is the reference's formula.
Log-decays are clipped to [−4, −1e−6], as in the reference, so
``exp(−lwI)`` overflows f32 once a chunk's log-decays sum below about
−88.7 (possible at chunk 64, not at init: about −8.7).

The params are the reference's tree, key for key (``tok_embed/table``,
``layers/{ln1,ln2,tm,cm}`` with layer-stacked leaves, ``final_norm``,
``lm_head/table``).  The reference's ``lax.scan`` over layers is a loop
over the stacked leaves' slices, each layer under
``torch.utils.checkpoint`` in training (its remat).  The recurrent
state is ``{"tm_x", "cm_x", "S"}`` (layer-stacked, f32); decode writes
it in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import embed, layer_slices, logits_fn

Params = Dict[str, Any]

LOG_DECAY_CLIP = 4.0


# ---------------------------------------------------------------------------
# wkv core
# ---------------------------------------------------------------------------

def wkv_step(r, k, v, logw, u, S):
    """One step.  r, k, v, logw (b, h, K|V); u (h, K); S (b, h, K, V).
    Returns (out (b, h, V), S')."""
    kv = k[..., :, None] * v[..., None, :]
    wkv = u[None, :, :, None] * kv + S
    out = torch.einsum("bhk,bhkv->bhv", r, wkv)
    S = torch.exp(logw)[..., None] * S + kv
    return out, S


def wkv_scan(r, k, v, logw, u, S0):
    """Sequential oracle.  r, k, v, logw: (b, s, h, K|V); u: (h, K); S0:
    (b, h, K, V).  Returns (out (b, s, h, V), S_final)."""
    S, outs = S0, []
    for t in range(r.shape[1]):
        out, S = wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, S)
        outs.append(out)
    return torch.stack(outs, dim=1), S


def wkv_chunked(r, k, v, logw, u, S0, chunk: int):
    """Chunked parallel form; shapes as in ``wkv_scan``.  Falls back to
    the scan when ``chunk`` does not divide the length."""
    b, s, h, K = r.shape
    V = v.shape[-1]
    if s % chunk != 0:
        return wkv_scan(r, k, v, logw, u, S0)
    n, L = s // chunk, chunk
    rb, kb, vb, lwb = (x.reshape(b, n, L, h, -1) for x in (r, k, v, logw))
    lwI = torch.cumsum(lwb, dim=2)                    # inclusive (b,n,L,h,K)
    lwX = lwI - lwb                                   # exclusive
    r_dec = rb * torch.exp(lwX)
    k_inv = kb * torch.exp(-lwI)
    # intra-chunk pairwise (strictly causal j < i)
    scores = torch.einsum("bnihk,bnjhk->bnhij", r_dec, k_inv)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    scores = torch.where(mask, scores, torch.zeros((), dtype=scores.dtype,
                                                   device=r.device))
    out = torch.einsum("bnhij,bnjhv->bnihv", scores, vb)
    # current-token bonus
    out = out + torch.einsum("bnihk,bnihv->bnihv", rb * u * kb, vb)
    # the state's contribution: each chunk reads the state before it
    lw_tot = lwI[:, :, -1]                            # (b,n,h,K)
    k_dec = kb * torch.exp(lw_tot[:, :, None] - lwI)
    kv = torch.einsum("bnjhk,bnjhv->bnhkv", k_dec, vb)
    decay = torch.exp(lw_tot)[..., None]              # (b,n,h,K,1)
    S, before = S0, []
    for c in range(n):
        before.append(S)
        S = decay[:, c] * S + kv[:, c]
    out = out + torch.einsum("bnihk,bnhkv->bnihv", r_dec,
                             torch.stack(before, dim=1))
    return out.reshape(b, s, h, V), S


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def layer_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """One layer's params; ``lead`` = (n_layers,) stacks them."""
    lead = tuple(lead)
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    lora = max(32, d // 64)

    def full(value, n=d):
        return torch.full(lead + (n,), value, dtype=torch.float32,
                          device=device)

    def dense(d_in, d_out, scale=None):
        return cm.dense_init(generator, d_in, d_out, scale, lead=lead,
                             device=device)

    # drawn in this order: wr wk wv wg wo, the decay LoRA, u; then the
    # channel mix's wk wv wr
    tm = {"mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
          "mix_g": full(0.5), "mix_w": full(0.5),
          "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
          "wg": dense(d, d), "wo": dense(d, d),
          # v6 data-dependent decay LoRA: w = base + tanh(x A) B
          "w_base": full(-2.0),
          "w_A": dense(d, lora, 0.01), "w_B": dense(lora, d, 0.01),
          "u": cm.normal(generator, lead + (h, hd), device, 0.1),
          "gn": full(1.0)}
    cmix = {"mix_k": full(0.5), "mix_r": full(0.5),
            "wk": dense(d, f), "wv": dense(f, d), "wr": dense(d, d)}
    return {"ln1": full(1.0), "ln2": full(1.0), "tm": tm, "cm": cmix}


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}; position 0 takes ``prev`` (carry or zeros)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def time_mix(cfg: ArchConfig, p, x: torch.Tensor, x_prev: torch.Tensor,
             S0: torch.Tensor, mode: str):
    """x (b,s,d); x_prev (b,d) carry; S0 (b,h,K,V).  Returns (out, x_last,
    S).  r, k, v and g are GEMMs in the compute dtype, then f32; the
    decay LoRA runs in f32; the group norm is an rmsnorm over all of d."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = x.dtype
    xs = _shift(x, x_prev)

    def lerp(mix):
        return x + mix.to(dt) * (xs - x)

    r = (lerp(p["mix_r"]) @ p["wr"].to(dt)).reshape(b, s, h, hd)
    k = (lerp(p["mix_k"]) @ p["wk"].to(dt)).reshape(b, s, h, hd)
    v = (lerp(p["mix_v"]) @ p["wv"].to(dt)).reshape(b, s, h, hd)
    g = lerp(p["mix_g"]) @ p["wg"].to(dt)
    xw = lerp(p["mix_w"]).to(torch.float32)
    dd = torch.tanh(xw @ p["w_A"]) @ p["w_B"]
    logw = -torch.exp(p["w_base"][None, None] + dd)    # (b,s,d) < 0
    logw = torch.clamp(logw, -LOG_DECAY_CLIP, -1e-6).reshape(b, s, h, hd)

    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    if mode == "chunked":
        out, S = wkv_chunked(rf, kf, vf, logw, p["u"], S0, cfg.rwkv_chunk)
    else:
        out, S = wkv_scan(rf, kf, vf, logw, p["u"], S0)
    out = cm.rmsnorm(out.reshape(b, s, d), p["gn"])    # head-group norm
    out = (out * F.silu(g.to(torch.float32))).to(dt)
    return out @ p["wo"].to(dt), x[:, -1], S


def channel_mix(cfg: ArchConfig, p, x: torch.Tensor, x_prev: torch.Tensor):
    dt = x.dtype
    xs = _shift(x, x_prev)
    xk = x + p["mix_k"].to(dt) * (xs - x)
    xr = x + p["mix_r"].to(dt) * (xs - x)
    kk = torch.square(F.relu(xk @ p["wk"].to(dt)))
    return (torch.sigmoid(xr @ p["wr"].to(dt)) * (kk @ p["wv"].to(dt)),
            x[:, -1])


def layer_apply(cfg: ArchConfig, p, x: torch.Tensor, state, mode: str):
    """state: dict(tm_x (b,d), cm_x (b,d), S (b,h,K,V)).  Returns (x',
    state'), the carries in f32."""
    h = cm.rmsnorm(x, p["ln1"])
    o, tm_x, S = time_mix(cfg, p["tm"], h, state["tm_x"].to(h.dtype),
                          state["S"], mode)
    x = x + o
    h = cm.rmsnorm(x, p["ln2"])
    o, cm_x = channel_mix(cfg, p["cm"], h, state["cm_x"].to(h.dtype))
    return x + o, {"tm_x": tm_x.to(torch.float32),
                   "cm_x": cm_x.to(torch.float32), "S": S}


def zero_state(cfg: ArchConfig, batch: int, device="cuda"):
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    L, d = cfg.n_layers, cfg.d_model
    return {
        "tm_x": torch.zeros((L, batch, d), dtype=torch.float32,
                            device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=torch.float32,
                            device=device),
        "S": torch.zeros((L, batch, h, hd, hd), dtype=torch.float32,
                         device=device),
    }


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init(generator: Optional[torch.Generator], cfg: ArchConfig,
         device=None) -> Params:
    """The reference's params tree, drawn from ``generator`` on ``device``
    (default: the generator's, or the card without one); on the ``meta``
    device it allocates nothing."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    # drawn in this order: the embedding, the layers, the head
    tok_embed = cm.embed_init(generator, cfg.vocab, cfg.d_model,
                              device=device)
    layers = layer_init(generator, cfg, lead=(cfg.n_layers,), device=device)
    return {"tok_embed": {"table": tok_embed},
            "layers": layers,
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=device),
            "lm_head": {"table": cm.embed_init(generator, cfg.vocab,
                                               cfg.d_model, device=device)}}


def _state_slice(state, i: int):
    return {k: v[i] for k, v in state.items()}


def _run_stack(cfg: ArchConfig, params: Params, x: torch.Tensor, state,
               mode: str, remat: bool = False):
    """Every layer over x (b, s, d) from the layer-stacked ``state``.
    Returns (x, the final state, layer-stacked)."""
    def body(lp, h, st):
        return layer_apply(cfg, lp, h, st, mode)

    finals = []
    for i, lp in enumerate(layer_slices(params["layers"])):
        st = _state_slice(state, i)
        if remat and torch.is_grad_enabled():
            x, st = checkpoint(body, lp, x, st, use_reentrant=False)
        else:
            x, st = body(lp, x, st)
        finals.append(st)
    return x, {k: torch.stack([st[k] for st in finals]) for k in state}


def train_loss(cfg: ArchConfig, params: Params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    state = zero_state(cfg, tokens.shape[0], device=x.device)
    x, _ = _run_stack(cfg, params, x, state, "chunked", remat=remat)
    return cm.head_loss(cfg, cm.rmsnorm(x, params["final_norm"]),
                        params["lm_head"]["table"], batch, sampled_softmax)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_seq: Optional[int] = None):
    """Returns (last-position logits (b, vocab), state); the state holds
    no length (``serve.steps`` adds ``len``)."""
    x = embed(cfg, params, tokens)
    state = zero_state(cfg, tokens.shape[0], device=x.device)
    x, state = _run_stack(cfg, params, x, state, "chunked")
    return logits_fn(cfg, params, x[:, -1:])[:, 0], state


def decode_step(cfg: ArchConfig, params: Params, state, token: torch.Tensor):
    """token (b,) int32.  Returns (logits (b, vocab), state'): each
    layer's new carries are written into ``state``'s tensors IN PLACE."""
    x = embed(cfg, params, token[:, None])
    for i, lp in enumerate(layer_slices(params["layers"])):
        x, st = layer_apply(cfg, lp, x, _state_slice(state, i), "scan")
        for k, v in st.items():
            state[k][i] = v
    return logits_fn(cfg, params, x)[:, 0], state
