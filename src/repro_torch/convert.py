"""Hand one state between the two packages as numpy arrays.

``tree_from_numpy`` turns nested dicts/lists of numpy arrays (a params tree,
or the reference's ``{"step", "m", "v"}`` optimizer state with its
per-path trees of None, dense arrays and sketches, e.g. ``jax.device_get``
of them) into the port's tensors; ``tree_to_numpy`` goes the other way.  The
step counter stays on the host as an int32 scalar, where the port keeps
it.  Tests and the chip smoke script start both packages from one state
this way, since the port draws its initial numbers from other
generators than ``jax.random``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts/lists/tuples of arrays -> the same tree of float32
    tensors on ``device``; None stays None, and a ``"step"`` entry
    becomes a host int32 scalar."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (torch.tensor(int(np.asarray(v)), dtype=torch.int32)
                    if k == "step" else tree_from_numpy(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def tree_to_numpy(tree):
    """The reverse of ``tree_from_numpy``: numpy copies in the reference's
    layout, the step an int32 scalar."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (np.asarray(int(v), np.int32) if k == "step"
                    else tree_to_numpy(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def from_jax_state(table_np: np.ndarray, opt_state_np: Dict, device="cuda"
                   ) -> Tuple[torch.Tensor, Dict]:
    """(table, opt_state) of the sparse-rows step on ``device``."""
    return (tree_from_numpy(table_np, device),
            tree_from_numpy(opt_state_np, device))


def to_numpy(table: torch.Tensor, opt_state: Dict) -> Tuple[np.ndarray, Dict]:
    """The reverse of ``from_jax_state``."""
    return tree_to_numpy(table), tree_to_numpy(opt_state)
