"""Model FLOPs of the ``hybrid_moe`` family (GraniteMoeHybrid), which
the frozen ``harness.arith`` does not count: 6·N a token plus the
sequence mixers' products, as ``arith.lm_flops_per_token`` counts the
other families.

N is the active parameters other than the embedding table, counted as
the products' weights: per Mamba2 layer the z, x, B·C, dt and output
projections; per attention layer Q, K, V and O; per layer the router,
the shared expert and the held experts at their expected share of a
token, ``top_k · held / n_experts`` experts of 3·d·f each (the top-k
choices fall on the held experts in that proportion on average); and
the vocabulary head.  Norms, the convs' taps, the decay, skip and bias
vectors are elementwise and not counted.

The mixers: attention's 12·heads·head_dim·seq a layer (PaLM,
arXiv:2204.02311, appendix B), and the SSD's chunked products a Mamba2
layer, three times their forward (forward and backward), at the
program's chunk L (``rwkv_chunk``): C·Bᵀ within a chunk (2·L·n a token,
shared by the heads), the chunk's masked matrix times x (2·L·h·p), each
token's part of the chunk's state (2·h·p·n) and the state's part of
each output (2·h·p·n).  Recomputation under checkpoint is not counted.
"""
from __future__ import annotations


def held(c: dict) -> int:
    return c.get("experts_held") or c["n_experts"]


def _types(c: dict):
    return list(c["layer_types"][:c["n_layers"]])


def mamba_params(c: dict) -> int:
    d, n, hp = c["d_model"], c["ssm_state"], c["ssm_head_dim"]
    di = c["ssm_expand"] * d
    return d * (2 * di + 2 * n + di // hp) + di * d


def attention_params(c: dict) -> int:
    d, hq, hkv, hd = c["d_model"], c["n_heads"], c["n_kv"], c["head_dim"]
    return d * hq * hd + 2 * d * hkv * hd + hq * hd * d


def moe_active_params(c: dict) -> int:
    """The router, the shared expert and the held experts' expected
    share of one token."""
    d, f = c["d_model"], c["d_ff"]
    experts = 3 * d * f * c["top_k"] * held(c) // c["n_experts"]
    return d * c["n_experts"] + 3 * d * c["shared_d_ff"] + experts


def active_params(c: dict) -> int:
    t = _types(c)
    return (t.count("mamba") * mamba_params(c)
            + t.count("attention") * attention_params(c)
            + c["n_layers"] * moe_active_params(c)
            + c["vocab_size"] * c["d_model"])


def ssd_flops_per_token(c: dict) -> int:
    """One Mamba2 layer's SSD products a token, forward and backward."""
    L, n, hp = c["rwkv_chunk"], c["ssm_state"], c["ssm_head_dim"]
    h = c["ssm_expand"] * c["d_model"] // hp
    return 3 * (2 * L * n + 2 * L * h * hp + 4 * h * hp * n)


def mixer_flops_per_token(c: dict, seq: int) -> int:
    t = _types(c)
    return (t.count("attention") * 12 * c["n_heads"] * c["head_dim"] * seq
            + t.count("mamba") * ssd_flops_per_token(c))


def lm_flops_per_token(c: dict, seq: int) -> int:
    return 6 * active_params(c) + mixer_flops_per_token(c, seq)


def expert_flops_per_row(c: dict) -> int:
    """The forward FLOPs of one assignment through a held expert: its
    gate, up and down products, 2·d·f each."""
    return 2 * 3 * c["d_model"] * c["d_ff"]
