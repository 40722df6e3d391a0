"""InternVL2-style VLM: stubbed ViT frontend and an InternLM2 text
backbone.

Counterpart of ``repro.models.vlm``.  The vision tower is a stub: the
caller feeds precomputed patch embeddings (b, n_patches, d_model),
already projected to the language model's width.  The backbone is the
transformer's dense GQA decoder (its params tree, its cache); the
multimodal part is prefix concatenation ([vision; text]) at positions
0..P+s-1, rope over the patches too, with the loss on the text
positions only.  Decode is the transformer's: the vision lives in the
prefix cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

init = tf.init
init_cache = tf.init_cache
decode_step = tf.decode_step


def _prefix(cfg: ArchConfig, params, patches: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    return torch.cat([patches.to(cfg.dtype), tf.embed(cfg, params, tokens)],
                     dim=1)


def train_loss(cfg: ArchConfig, params, batch: Dict[str, Any], *,
               remat: bool = True, sampled_softmax: bool = False
               ) -> torch.Tensor:
    """batch: patches (b, P, d_model), tokens (b, s), labels (b, s)."""
    patches, tokens = batch["patches"], batch["tokens"]
    b, P, _ = patches.shape
    s = tokens.shape[1]
    x = _prefix(cfg, params, patches, tokens)
    x, aux = tf.backbone_train(cfg, params, x,
                               tf._positions(b, P + s, x.device),
                               remat=remat)
    # the text positions only
    x = cm.rmsnorm(x[:, P:], params["final_norm"])
    loss = cm.head_loss(cfg, x, params["lm_head"]["table"], batch,
                        sampled_softmax)
    return loss + 0.01 * aux


def prefill(cfg: ArchConfig, params, patches: torch.Tensor,
            tokens: torch.Tensor, max_seq: Optional[int] = None):
    """Prefix = [vision; text]; returns (last logits, the transformer's
    cache of P + s positions, ``len`` P + s)."""
    return tf.prefill_embedded(cfg, params,
                               _prefix(cfg, params, patches, tokens),
                               max_seq)
