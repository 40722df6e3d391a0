"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L  d_model=4096  d_ff=14336  vocab=65536  (64 heads × head_dim 64).
Runs long_500k (O(1) recurrent state).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, head_dim=64,
    d_ff=14336, vocab_size=65536, rwkv_head_dim=64, rwkv_chunk=64,
    # Memory-planner budget (--aux-budget config): dense CS-Adam aux is
    # ~60.3 GB, floor ~56.0 GB (the 65k-vocab tables are the only
    # compressible mass on a 7B dense body) — 57 GB sketches both.
    aux_budget_bytes=57_000_000_000,
)
