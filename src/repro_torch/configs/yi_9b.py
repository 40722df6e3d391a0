"""yi-9b — llama-arch dense GQA [arXiv:2403.04652; hf].

48L  d_model=4096  32H (GQA kv=4, head_dim=128)  d_ff=11008  vocab=64000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="gqa",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
)
