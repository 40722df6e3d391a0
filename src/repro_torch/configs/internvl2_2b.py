"""internvl2-2b — InternViT (stub) + InternLM2-chat-1.8b backbone
[arXiv:2404.16821; hf].

24L  d_model=2048  16H (GQA kv=8, head_dim=128)  d_ff=8192  vocab=92553.
The vision tower is a STUB: ``input_specs`` provides 256 pre-projected
patch embeddings (448 px, pixel-unshuffle 0.5) prepended to the text.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=8192, vocab_size=92553, n_patches=256,
)
