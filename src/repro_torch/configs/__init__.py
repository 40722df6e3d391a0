"""Architecture registry: the shapes of the ten assigned models.

Counterpart of ``repro.configs`` without the XLA dry run's
``input_specs`` and ``cell_skip`` (ROADMAP A14b).  Every ``<arch>.py``
module defines ``CONFIG`` (exact public dims, see its ``[source]``
note); ``get`` takes an id or an alias.
"""
from __future__ import annotations

import importlib
from typing import Dict

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
