"""qwen2-0.5b — GQA with QKV bias [arXiv:2407.10671; hf].

24L  d_model=896  14H (GQA kv=2, head_dim=64)  d_ff=4864  vocab=151936.
Two vocabulary tables: ``tie_embeddings=True`` is read by no code of
either package (ROADMAP C).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="gqa",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, head_dim=64,
    d_ff=4864, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    # Aux-state budget for the memory planner (--aux-budget config):
    # dense CS-Adam aux is ~5.04 GB; 4.6 GB makes the planner fund the
    # vocab tables' sketches from the savings (DESIGN.md §11).
    aux_budget_bytes=4_600_000_000,
)
