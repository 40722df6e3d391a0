"""zamba2-2.7b — Mamba2 backbone + ONE weight-shared attention block
applied every 6th layer [arXiv:2411.15242; hf].

54L  d_model=2560  32H (kv=32, head_dim=80 for the shared block)
d_ff=10240 (shared block MLP)  vocab=32000  ssm_state=64
(d_inner = 2·2560 = 5120, 80 SSM heads × head_dim 64).
Runs long_500k (hybrid: O(1) SSM state + seq-sharded KV for the shared
attention sites).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    rwkv_chunk=64,
)
