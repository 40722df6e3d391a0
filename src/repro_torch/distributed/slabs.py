"""Cutting a sharded optimizer state into its shards' slabs, and back.

The counterpart of the in/out specs of the reference's
``sharded_sparse_wrap`` (``repro/distributed/sharding.py``), which give
each (dp × shard) device the slab ``S[:, s·lw:(s+1)·lw]`` of every
rank-3 (depth, width, dim) state leaf and replicate the rest.  The port
has no placement: each replica of a ``ReplicaMesh`` or a process group
holds its own slabs, cut here from the full ``opt.init()`` state, as
contiguous copies (B5 writes a contiguous slab).  ``join_slabs`` is the
inverse, for comparison and checkpoints.

    states = [shard_state(opt.init(), shards, s) for s in range(shards)]
    full = join_slabs(states)
"""
from __future__ import annotations

from typing import Any, Sequence

import torch


def _is_slabbed(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dim() == 3


def shard_state(state: Any, shards: int, shard: int) -> Any:
    """``state`` with every rank-3 tensor leaf (m, v, residual) replaced by
    a contiguous copy of shard ``shard``'s width slab; every other leaf
    (the step counter, None) is kept as it is."""
    if isinstance(state, dict):
        return {k: shard_state(v, shards, shard) for k, v in state.items()}
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        return type(state)(shard_state(v, shards, shard) for v in state)
    if _is_slabbed(state):
        width = state.shape[1]
        if width % shards:
            raise ValueError(f"width {width} does not divide into {shards} "
                             f"slabs")
        lw = width // shards
        return state[:, shard * lw:(shard + 1) * lw].clone(
            memory_format=torch.contiguous_format)
    return state


def join_slabs(states: Sequence[Any]) -> Any:
    """The inverse of ``shard_state``: the shards' states, in shard order,
    with every rank-3 tensor leaf concatenated along the width; every
    other leaf taken from shard 0."""
    first = states[0]
    if isinstance(first, dict):
        return {k: join_slabs([st[k] for st in states]) for k in first}
    if isinstance(first, (list, tuple)) and not hasattr(first, "_fields"):
        return type(first)(join_slabs([st[i] for st in states])
                           for i in range(len(first)))
    if _is_slabbed(first):
        return torch.cat(list(states), dim=1)
    return first
