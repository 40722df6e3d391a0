"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L  d_model=2048  16H (kv=16, head_dim=128)  d_ff=1408 per expert
vocab=151936.  The 4 shared experts are merged into one 4·1408-wide
SwiGLU (mathematically identical).  60 experts do not divide the 16-way
'model' axis ⇒ ``expert_sharding='tp'`` shards each expert's d_ff instead
(DESIGN.md §4).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    n_experts=60, top_k=4, shared_d_ff=4 * 1408, expert_sharding="tp",
)
