"""Shared model building blocks: pure functions over nested dicts of
tensors.

Counterpart of ``repro.models.common``.  The conventions are the
reference's:

* Params are nested dicts of tensors.  Layer stacks keep leaves with a
  leading ``n_layers`` axis; the model loops over their slices.
* Embedding and vocab-projection tables are vocab-major ``(vocab, d)``,
  so the count-sketch optimizer hashes rows (classes), as in the paper.
* Mixed precision: master params f32, cast to ``cfg.compute_dtype`` where
  a forward uses them; losses and softmax in f32.

The port runs on one device, so the reference's activation sharding
constraint ``shard_act`` is the identity.  Divisions by a constant go
through ``kernels.ref.true_div``: PyTorch's CUDA division by a Python
scalar multiplies by its reciprocal, which rounds otherwise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.transforms import tree_map_with_path
from repro_torch.kernels.ref import true_div

Params = Dict[str, Any]


def shard_act(x, *rest):
    """The reference's activation sharding constraint; one device has no
    mesh to constrain to."""
    return x


def cast_tree(tree, dtype: torch.dtype):
    """Floating leaves of ``tree`` as ``dtype``; other leaves unchanged."""
    return tree_map_with_path(
        lambda _p, x: x.to(dtype) if x.is_floating_point() else x, tree)


def normal(generator: Optional[torch.Generator], shape, device,
           scale: float) -> torch.Tensor:
    """f32 normal draws times ``scale``.  On the ``meta`` device (shapes
    only) no generator is used and nothing is allocated."""
    gen = None if torch.device(device).type == "meta" else generator
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return x * np.float32(scale)


def dense_init(generator, d_in: int, d_out: int, scale: Optional[float] = None,
               *, lead=(), device="cuda") -> torch.Tensor:
    """(…lead, d_in, d_out) f32 normals at the reference's scale
    1/√d_in.  The draws are torch's, not ``jax.random``'s: start both
    packages from one state with ``repro_torch.convert``."""
    scale = scale if scale is not None else \
        float(np.float32(1.0) / np.sqrt(np.float32(d_in)))
    return normal(generator, tuple(lead) + (d_in, d_out), device, scale)


def embed_init(generator, vocab: int, d: int, *, device="cuda"
               ) -> torch.Tensor:
    return normal(generator, (vocab, d), device, 0.02)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                        + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

_ROPE_FREQS: Dict[Any, torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float = 10000.0, device="cuda"
               ) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies, formed on the host and
    kept on ``device``: a copy from pageable host memory would wait for
    the card's queue at every call."""
    key = (head_dim, float(theta), torch.device(device))
    if key not in _ROPE_FREQS:
        e = true_div(torch.arange(0, head_dim, 2, dtype=torch.float32),
                     float(head_dim))
        _ROPE_FREQS[key] = (1.0 / torch.pow(
            torch.tensor(theta, dtype=torch.float32), e)).to(device)
    return _ROPE_FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    Angles, cos and sin are formed in f32 and the rotation multiplies in
    the INPUT dtype, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_positions(seq: int, d: int, device="cuda") -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * np.float32(-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32.  logits (..., V), labels (...)"""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _masked_mean(logz - gold, mask)


def _xent_chunk(xc: torch.Tensor, lc: torch.Tensor, table: torch.Tensor,
                divisor: float = 1.0) -> torch.Tensor:
    logits = torch.matmul(xc, table.to(xc.dtype).T).to(torch.float32)
    if divisor != 1.0:
        logits = true_div(logits, divisor)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         divisor: float = 1.0) -> torch.Tensor:
    """Full-softmax mean token xent WITHOUT materialising (b·s, V) logits.

    Runs over SEQUENCE chunks of ``chunk`` (one chunk when it does not
    divide s); each chunk's body runs under ``torch.utils.checkpoint``, so
    its (b, chunk, V) logits are formed again in the backward instead of
    being kept, as the reference's ``jax.checkpoint`` body does.  x (b, s,
    d); table (V, d); labels (b, s).  The logits are divided by
    ``divisor`` (GraniteMoeHybrid's ``logits_scaling``) before the
    softmax."""
    b, s, _ = x.shape
    if s % chunk != 0:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        xc, lc = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_xent_chunk, xc, lc, table, divisor,
                              use_reentrant=False)
        else:
            part = _xent_chunk(xc, lc, table, divisor)
        total = total + part
    return true_div(total, float(b * s))


def sampled_softmax_xent(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, sample_ids: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampled softmax (paper §7.2): logits only over {labels} ∪
    {samples}, so the softmax layer's gradient is row-sparse.

    x: (T, d) final hidden; table: (V, d); labels: (T,); sample_ids: (S,)
    negatives shared across the batch."""
    x = x.to(torch.float32)
    pos_rows = table[labels.long()].to(torch.float32)        # (T, d)
    neg_rows = table[sample_ids.long()].to(torch.float32)    # (S, d)
    pos_logit = torch.sum(x * pos_rows, dim=-1)              # (T,)
    neg_logits = x @ neg_rows.T                              # (T, S)
    # remove accidental hits (negatives equal to the label)
    hit = sample_ids[None, :] == labels[:, None]
    neg_logits = torch.where(hit, torch.full_like(neg_logits, -1e9),
                             neg_logits)
    logz = torch.logsumexp(
        torch.cat([pos_logit[:, None], neg_logits], dim=-1), dim=-1)
    return _masked_mean(logz - pos_logit, mask)


def head_loss(cfg, x: torch.Tensor, table: torch.Tensor,
              batch: Dict[str, Any], sampled_softmax: bool = False
              ) -> torch.Tensor:
    """The LM loss of the final-normed hidden states x (b, s, d) against
    ``batch["labels"]`` (b, s) through the vocabulary table: the chunked
    full softmax, or the sampled one over ``batch["neg_ids"]``."""
    labels = batch["labels"]
    if sampled_softmax:
        b, s = labels.shape
        return sampled_softmax_xent(x.reshape(b * s, -1), table,
                                    labels.reshape(-1), batch["neg_ids"])
    return chunked_softmax_xent(x, table, labels, cfg.loss_chunk,
                                cfg.logits_scaling)
