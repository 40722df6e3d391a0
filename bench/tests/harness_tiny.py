"""Tiny cells for the harness tests: the real cells' configurations cut
to a size the CPU runs in a fraction of a second, float32 products, the
real traffic mixes cut to a few short sequences."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

TINY_ARCH = {
    "gqa": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
                d_ff=128, vocab_size=2048, attn_chunk=16, loss_chunk=16,
                compute_dtype="float32"),
    "rwkv6": dict(n_layers=2, d_model=64, n_heads=2, n_kv=2, head_dim=32,
                  d_ff=128, vocab_size=2048, rwkv_head_dim=32, rwkv_chunk=8,
                  loss_chunk=16, compute_dtype="float32"),
}
TINY_TRAFFIC = {"sparse_rows": dict(batch=4, seq_len=64, pool=4),
                "lm_train": dict(batch=2, seq_len=32, pool=4)}


def tiny_spec(cell: str) -> manifest.CellSpec:
    """``cell`` of ``BENCHMARK.json`` with its configuration and traffic
    cut to tiny sizes; its limits as committed."""
    spec = manifest.cell(cell)
    config = json.loads(json.dumps(spec.config))
    config["arch"].update(TINY_ARCH[config["arch"]["family"]])
    traffic = dict(spec.traffic, **TINY_TRAFFIC[spec.traffic["kind"]])
    spec.config, spec.traffic = config, traffic
    return spec
