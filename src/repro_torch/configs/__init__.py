"""Architecture registry and per-cell input specs.

    from repro_torch.configs import get, registry, input_specs, cell_skip

Counterpart of ``repro.configs``.  Every ``<arch>.py`` module defines
``CONFIG`` (exact public dims, see its ``[source]`` note); ``get`` takes
an id or an alias.  ``input_specs(cfg, shape)`` and the other spec
functions return a cell's inputs as ``meta`` tensors (shapes and dtypes,
no allocation) where the reference returns ``ShapeDtypeStruct``s;
``cell_skip`` encodes the shape-skip rule (long_500k only for the
sub-quadratic archs).  ``decode_cache_specs`` reads the family's serve
cache (``serve.steps.cache_factory``): the recurrent state and ``len``
of rwkv6, the mamba state and the shared block's KV caches of hybrid.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.config import ArchConfig, ShapeConfig, SHAPES  # noqa: F401

ARCH_IDS = (
    "internlm2_20b",
    "yi_9b",
    "granite_20b",
    "qwen2_0_5b",
    "rwkv6_7b",
    "whisper_medium",
    "internvl2_2b",
    "zamba2_2_7b",
    "qwen2_moe_a2_7b",
    "llama4_maverick_400b_a17b",
)

_ALIASES = {
    "internlm2-20b": "internlm2_20b",
    "yi-9b": "yi_9b",
    "granite-20b": "granite_20b",
    "qwen2-0.5b": "qwen2_0_5b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-medium": "whisper_medium",
    "internvl2-2b": "internvl2_2b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def get(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.CONFIG


def registry() -> Dict[str, ArchConfig]:
    return {a: get(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Cell matrix (arch × shape) skip rules
# ---------------------------------------------------------------------------

SUBQUADRATIC = {"rwkv6_7b", "zamba2_2_7b"}


def cell_skip(arch: str, shape: str) -> Optional[str]:
    """None if the cell runs; otherwise the reason it is skipped."""
    arch = _ALIASES.get(arch, arch)
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return ("long_500k needs sub-quadratic attention; "
                f"{arch} is full-attention (DESIGN.md §6)")
    return None


def cells():
    """All effective (arch, shape) pairs."""
    for a in ARCH_IDS:
        for s in SHAPES:
            if cell_skip(a, s) is None:
                yield a, s


# ---------------------------------------------------------------------------
# Input specs (``meta`` tensors, no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _stub_specs(cfg: ArchConfig, B: int, S: int):
    """The stub frontend's batch entries and the text length: the VLM's
    patches count in the cell's ``seq_len``."""
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = _spec((B, cfg.enc_seq, cfg.d_model),
                                cfg.compute_dtype)
    if cfg.family == "vlm":
        batch["patches"] = _spec((B, cfg.n_patches, cfg.d_model),
                                 cfg.compute_dtype)
        S = S - cfg.n_patches        # total positions == the cell's seq_len
    return batch, S


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      sampled_softmax: bool = False) -> Dict:
    """The train step's ``batch`` argument."""
    batch = {}
    if sampled_softmax:
        batch["neg_ids"] = _spec((cfg.softmax_samples,), torch.int32)
    stub, S = _stub_specs(cfg, shape.global_batch, shape.seq_len)
    batch.update(stub)
    batch["tokens"] = _spec((shape.global_batch, S), torch.int32)
    batch["labels"] = _spec((shape.global_batch, S), torch.int32)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    batch, S = _stub_specs(cfg, shape.global_batch, shape.seq_len)
    batch["tokens"] = _spec((shape.global_batch, S), torch.int32)
    return batch


def decode_cache_specs(cfg: ArchConfig, shape: ShapeConfig):
    """The family's zeroed serve cache on ``meta`` (no allocation)."""
    from repro_torch.serve.steps import cache_factory
    return cache_factory(cfg, "meta")(batch=shape.global_batch,
                                      max_seq=shape.seq_len)


def decode_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    return {"token": _spec((shape.global_batch,), torch.int32)}


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape)
    return decode_batch_specs(cfg, shape)
