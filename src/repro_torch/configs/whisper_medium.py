"""whisper-medium — enc-dec, conv audio frontend STUBBED [arXiv:2212.04356].

24L decoder (+24L encoder)  d_model=1024  16H (kv=16, head_dim=64)
d_ff=4096  vocab=51865.  ``input_specs`` feeds precomputed frame
embeddings (b, enc_seq, d) — 30 s of audio after the conv stride-2 stem.
enc_seq is padded 1500 → 1536 so flash-attention chunking divides evenly
(the stub frontend pads with silence frames; real Whisper pads audio to 30 s).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=4096, vocab_size=51865, enc_layers=24, enc_seq=1536,
    norm="layernorm", act="gelu", attn_chunk=512,
)
