"""granite-4.0-h-small — GraniteMoeHybrid 32B-A9B: 36 Mamba2 and 4 NoPE
attention layers, a 72-expert top-10 MoE and a shared expert after every
mixer [hf:ibm-granite/granite-4.0-h-small].

40L  d_model=4096  attention 32H (kv=8, head_dim=128) at layers 5, 15,
25, 35; Mamba2 128 heads × 64 (d_inner 8192), d_state 128, one group,
conv 4 with bias, chunk 256; experts of width 768, top-10 of 72 (gates a
softmax over the chosen logits), shared expert 1536; embedding × 12,
each mixer and FFN output × 0.22, logits / 16, softmax scale 1/128;
vocab=100352, RMSNorm eps 1e-5.  Every expert held here: a benchmark
configuration sets ``experts_held`` to one rank's share.  Not in
``ARCH_IDS``: the reference package has no such family.
"""
from repro_torch.models.config import ArchConfig

LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ArchConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=768, vocab_size=100352, tie_embeddings=True,
    n_experts=72, top_k=10, shared_d_ff=1536, expert_sharding="ep",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    rwkv_chunk=256, mamba_gate_first=True,
    layer_types=LAYER_TYPES,
    attention_multiplier=0.0078125, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
)
