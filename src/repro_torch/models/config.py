"""Architecture and run configuration.

Counterpart of ``repro.models.config``: the same fields, defaults and
``reduced()`` smoke config, with ``dtype`` a ``torch.dtype``.  The port
adds the fields of the ``hybrid_moe`` family (GraniteMoeHybrid,
``models/granite.py``), which the reference lacks; their defaults leave
every other family as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def pad_to_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # gqa | moe | rwkv6 | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab_size: int              # raw (paper) vocab; padded derived below
    head_dim: int = 128
    qkv_bias: bool = False
    repeat_kv: bool = False      # replicate KV heads to hq for clean TP
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    # read by no code of either package: both build two vocabulary
    # tables (tok_embed, lm_head) whatever this says
    tie_embeddings: bool = False

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    shared_d_ff: int = 0         # shared-expert hidden size (0 = none)
    capacity_factor: float = 1.25
    expert_sharding: str = "tp"  # tp: shard expert d_ff; ep: shard experts
    moe_every: int = 1           # llama4: MoE every Nth layer, dense between
    dense_d_ff: int = 0          # d_ff of interleaved dense layers (moe_every>1)
    fsdp: bool = False           # shard master weights over data/pod (llama4)
    moe_groups: int = 32         # grouped dispatch (aligned with DP shards)
    # expert parallelism (hybrid_moe): this device holds experts
    # [expert_rank * experts_held, (expert_rank + 1) * experts_held) of
    # n_experts; 0 holds them all
    experts_held: int = 0
    expert_rank: int = 0

    # --- SSM / hybrid ----------------------------------------------------
    ssm_state: int = 0           # Mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0          # zamba2: shared attn block every N layers
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 16         # also the Mamba2 SSD's chunk
    # the Mamba2 gated norm: rmsnorm(y·silu(z)), not rmsnorm(y)·silu(z)
    mamba_gate_first: bool = False

    # --- hybrid_moe (GraniteMoeHybrid) ----------------------------------
    layer_types: Tuple[str, ...] = ()    # "mamba" | "attention" a layer
    attention_multiplier: float = 0.0    # softmax scale; 0 = 1/sqrt(head_dim)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0     # each mixer and FFN output
    logits_scaling: float = 1.0          # the logits' divisor
    norm_eps: float = 1e-6               # read by hybrid_moe's norms

    # --- enc-dec / multimodal --------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 0             # stub frontend sequence length (frames/patches)
    n_patches: int = 0           # vlm: patch embeddings prepended to text

    # --- numerics / padding ----------------------------------------------
    compute_dtype: str = "bfloat16"
    vocab_multiple: int = 128    # pad vocab so TP axes divide (+ MXU align)
    attn_chunk: int = 1024
    loss_chunk: int = 512        # chunked-xent seq-chunk (see common.py)
    softmax_samples: int = 8192  # negatives for sampled softmax (paper §7.2)

    # --- count-sketch optimizer integration -------------------------------
    sketch_compression: float = 5.0
    sketch_depth: int = 3
    # Aux-memory budget in bytes for the optimizer state (None = no budget:
    # the regex SketchPolicy + global compression above); the planner
    # (``repro_torch.plan``) solves per-leaf layouts under it when an
    # entry point asks for --aux-budget config.
    aux_budget_bytes: Optional[int] = None

    def __post_init__(self):
        # a configuration file gives the layer pattern as a list
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @property
    def vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_multiple)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers,
                         4 if (self.attn_every or self.moe_every > 1) else 2),
            d_model=128,
            n_heads=4, n_kv=max(1, min(self.n_kv, 2)), head_dim=32,
            d_ff=256, vocab_size=512, vocab_multiple=64,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_held=min(self.experts_held, 2) if self.experts_held
            else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            shared_d_ff=128 if self.shared_d_ff else 0,
            dense_d_ff=256 if self.dense_d_ff else 0,
            fsdp=False,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            n_patches=8 if self.n_patches else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            rwkv_head_dim=32,
            rwkv_chunk=4,
            attn_chunk=16,
            compute_dtype="float32",
            name=self.name + "-smoke",
            aux_budget_bytes=None,   # full-size budgets don't scale down
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
