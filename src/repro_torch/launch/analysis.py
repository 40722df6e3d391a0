"""Roofline terms, parameter counts and argument bytes of one step.

Counterpart of ``repro.launch.analysis``.  Three terms a (arch x shape
x grid) cell, in seconds a step on one H100:

    compute    = FLOPs a device / PEAK_FLOPS_BF16
    memory     = bytes a device / HBM_BW
    collective = the ring-model link bytes of every collective / NVLINK_BW

The counts come from ``launch.op_cost`` (an eager step, counted op by op
on the ``meta`` device or the card), where the reference reads them from
XLA's HLO.  The ring model is the reference's, per op with group size
g:

    all-reduce          2·bytes·(g−1)/g      (reduce-scatter + all-gather)
    all-gather          bytes_out·(g−1)/g
    reduce-scatter      bytes_out·(g−1)
    all-to-all          bytes·(g−1)/g
    collective-permute  bytes

``model_flops`` is 6·N·D for a train step and 2·N·D for serving, N the
active parameters (an MoE's routed experts count ``top_k / n_experts``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from repro_torch.core.partition import leaf_paths

# NVIDIA's data-sheet peaks for one H100 SXM5 80GB at its full 700 W
# limit, not measurements: the dense bf16 tensor-core rate, the HBM3
# rate, and NVLink 4's 900 GB/s in both directions, halved.  A card set
# below 700 W runs slower under load, so a measured time stands beside
# the card's name and power limit (``nvidia-smi``), e.g. "NVIDIA H100
# 80GB HBM3, 700.00 W".
PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s
HBM_BW = 3.35e12              # bytes/s
NVLINK_BW = 450e9             # bytes/s a direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_link_bytes(kind: str, nbytes: float, g: int) -> float:
    """The bytes one device sends over its links for one collective of
    ``kind`` whose result is ``nbytes``, in a group of ``g``."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind in ("all-gather", "all-to-all"):
        return nbytes * frac
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    bytes_accessed: float         # per device
    collective_link_bytes: float  # per device
    collectives: Dict[str, Dict]
    model_flops_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_link_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap bound: step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.step_s == 0:
            return 0.0
        return (self.model_flops_per_device / PEAK_FLOPS_BF16) / self.step_s

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_device / self.flops if self.flops else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_link_bytes": self.collective_link_bytes,
            "collectives": self.collectives,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s_bound": self.step_s,
            "model_flops_per_device": self.model_flops_per_device,
            "mfu_bound": self.mfu,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def tree_nbytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree`` (``meta`` tensors
    count as the tensors they describe)."""
    return int(sum(x.nbytes for _p, x in leaf_paths(tree)
                   if isinstance(x, torch.Tensor)))


def memory_dict(argument_bytes: int,
                peak_bytes: Optional[int] = None) -> Dict:
    """The record's ``memory``: the step's argument bytes (params,
    optimizer state, batch or cache) and ``peak_bytes_per_device``,
    which only a step run on a card measures
    (``torch.cuda.max_memory_allocated``); None elsewhere, never a
    guess.  It replaces the reference's ``memory_analysis_dict``, which
    XLA's buffer assignment answers before anything runs."""
    return {"argument_size_in_bytes": int(argument_bytes),
            "peak_bytes_per_device": (None if peak_bytes is None
                                      else int(peak_bytes))}


# ---------------------------------------------------------------------------
# Model-FLOPs (6·N·D) helpers
# ---------------------------------------------------------------------------

def count_params(shape_tree) -> int:
    return int(sum(x.numel() for _p, x in leaf_paths(shape_tree)
                   if isinstance(x, torch.Tensor)))


def active_params(cfg, shape_tree) -> int:
    """For MoE: non-expert params + (top_k / n_experts)·expert params."""
    total = 0
    for path, leaf in leaf_paths(shape_tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        size = leaf.numel()
        # routed-expert leaves are rank-4 once layer-stacked: (L, E, d, f);
        # the interleaved dense FFN / shared experts are rank-3 and stay
        # fully active
        if getattr(cfg, "n_experts", 0) and leaf.dim() >= 4 \
                and "shared" not in path \
                and re.search(r"w_(gate|up|down)$", path):
            size = int(size * cfg.top_k / cfg.n_experts)
        total += size
    return total


def model_flops(cfg, shape_tree, tokens: int, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (fwd only)."""
    n = active_params(cfg, shape_tree)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
