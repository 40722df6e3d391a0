"""granite-20b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324; hf].

52L  d_model=6144  48H (kv=1, head_dim=128)  d_ff=24576  vocab=49152.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="gqa",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    repeat_kv=True,   # hq divides TP-16, hkv doesn't
)
