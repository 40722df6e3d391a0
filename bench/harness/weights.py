"""Weights made by the benchmark from ``--seed``, on the device, one
large draw per leaf.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's path, so a leaf can be made again alone: the check of the
parameters' change and the reference take the starting values from here
and never from the program.  A configuration's ``init`` rules give each
leaf's distribution by the last part of its path (``"*"`` for the
rest):

* ``["normal", std]``: normal draws times ``std``;
* ``["fan_in"]``: normal draws over the square root of the fan-in, the
  second-to-last dimension (a (…, d_in, d_out) matrix);
* ``["const", value]``: every entry ``value``.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Sequence

import torch

_GOLDEN64 = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, path: str) -> int:
    return (int(seed) * _GOLDEN64 + zlib.crc32(path.encode())) % (2**63)


def rule_for(rules: dict, path: str):
    return rules.get(path.rsplit("/", 1)[-1], rules.get("*"))


def make(rules: dict, path: str, shape: Sequence[int], seed: int,
         device) -> torch.Tensor:
    """The starting value of leaf ``path``, float32 on ``device``."""
    rule = rule_for(rules, path)
    if rule is None:
        raise KeyError(f"no init rule for {path!r}")
    shape = tuple(int(s) for s in shape)
    if rule[0] == "const":
        return torch.full(shape, float(rule[1]), dtype=torch.float32,
                          device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if rule[0] == "normal":
        return x.mul_(float(rule[1]))
    if rule[0] == "fan_in":
        return x.mul_(1.0 / math.sqrt(shape[-2]))
    raise ValueError(f"unknown init rule {rule!r} at {path!r}")


def make_all(rules: dict, shapes: Dict[str, Sequence[int]], seed: int,
             device) -> Dict[str, torch.Tensor]:
    return {p: make(rules, p, s, seed, device) for p, s in shapes.items()}


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """A nested dict's leaves as ``{"a/b": leaf}``, keys sorted; None
    leaves dropped."""
    out: Dict[str, object] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    out[prefix] = tree
    return out


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
