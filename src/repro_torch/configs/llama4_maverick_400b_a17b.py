"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L  d_model=5120  40H (GQA kv=8, head_dim=128)  d_ff=8192 (experts)
vocab=202048, 128 routed experts top-1 + 1 shared expert.  MoE layers
interleave with dense-FFN layers (``moe_every=2``, dense d_ff=16384) —
that is what makes the total ≈400 B with 17 B active, matching the
"-400b-a17b" name; every-layer MoE would be ≈775 B.  ``fsdp=True`` is
the reference's sharding of the master weights over its data axes
(``distributed.sharding.spec_for``'s 'fsdp:' entries).  One MoE layer
holds 16.1 B parameters (64 GB in f32), so the model is run at
``reduced()`` on the CPU only.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=128, top_k=1, shared_d_ff=8192, expert_sharding="ep",
    moe_every=2, dense_d_ff=16384, fsdp=True,
    # per-DEVICE aux budget for the vocab tables (DESIGN.md §17): below
    # the unsharded CS-MV floor for a (202048, 5120) embedding + softmax
    # pair (two 3×256-wide sketch moments each ≈ 63 MB), so planning them
    # REQUIRES model-parallel sketch shards — the motivating config for
    # ``plan_for_tables(..., shards=N)``; the planner raises
    # ``InfeasibleBudgetError`` without sharding.
    aux_budget_bytes=48 * 2**20,
)
