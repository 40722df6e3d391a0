"""internlm2-20b — dense GQA transformer [arXiv:2403.17297; hf].

48L  d_model=6144  48H (GQA kv=8, head_dim=128)  d_ff=16384  vocab=92544.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="gqa",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab_size=92544,
    repeat_kv=True,   # hq divides TP-16, hkv doesn't
)
