"""Hand one state between the two packages as numpy arrays.

``tree_from_numpy`` turns nested dicts/lists of numpy arrays (a params tree,
or the reference's ``{"step", "m", "v"}`` optimizer state with its
per-path trees of None, dense arrays and sketches, e.g. ``jax.device_get``
of them) into the port's tensors; ``tree_to_numpy`` goes the other way.  The
step counter stays on the host as an int32 scalar, where the port keeps
it.  Float leaves become float32 tensors, except bfloat16 ones (numpy
arrays of ``ml_dtypes.bfloat16``), which stay bfloat16 bit for bit; an
int8 sketch state (any ``(cells, scales)`` NamedTuple, as the reference's
``QuantState``) becomes the port's ``QuantState``, and a rank-1 state
(any ``(r, c)`` NamedTuple, as the reference's ``Rank1Moment``) the
port's ``Rank1Moment``.  Tests and the chip
smoke script start both packages from one state this way, since the port
draws its initial numbers from other generators than ``jax.random``.
A model's params tree (``tok_embed``, the layer-stacked ``layers``, …)
and a trainer state travel the same way: ``train_state_from_numpy``
builds the port's ``TrainState`` from a step and the reference's params
and optimizer state as numpy, ``train_state_to_numpy`` goes back.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import QuantState
from repro_torch.core.stores import Rank1Moment


def _port_named(tree):
    """The port's NamedTuple class with ``tree``'s fields (``QuantState``,
    ``Rank1Moment``), or None."""
    fields = getattr(tree, "_fields", None) if isinstance(tree, tuple) \
        else None
    for cls in (QuantState, Rank1Moment):
        if fields == cls._fields:
            return cls
    return None


def _leaf_from_numpy(a, device, exact: bool = False) -> torch.Tensor:
    """One array as a tensor: bfloat16 bit for bit, else float32 (its own
    dtype when ``exact``)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype=None if exact
                                     else np.float32)).to(device)


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts/lists/tuples of arrays -> the same tree of tensors on
    ``device`` (float32, or bfloat16 for bfloat16 arrays; int8 cells stay
    int8); None stays None, a ``"step"`` entry becomes a host int32
    scalar, a ``(cells, scales)`` NamedTuple a ``QuantState`` and an
    ``(r, c)`` NamedTuple a ``Rank1Moment``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (torch.tensor(int(np.asarray(v)), dtype=torch.int32)
                    if k == "step" else tree_from_numpy(v, device))
                for k, v in tree.items()}
    named = _port_named(tree)
    if named is not None:
        return named(*(_leaf_from_numpy(a, device, exact=True)
                       for a in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return _leaf_from_numpy(tree, device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # JAX's numpy bfloat16, installed with it
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def tree_to_numpy(tree):
    """The reverse of ``tree_from_numpy``: numpy copies in the reference's
    layout (bfloat16 leaves as ``ml_dtypes.bfloat16`` arrays), the step an
    int32 scalar, a ``QuantState`` or ``Rank1Moment`` one of arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (np.asarray(int(v), np.int32) if k == "step"
                    else tree_to_numpy(v)) for k, v in tree.items()}
    if isinstance(tree, (QuantState, Rank1Moment)):
        return type(tree)(*(_leaf_to_numpy(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)


def from_jax_state(table_np: np.ndarray, opt_state_np: Dict, device="cuda"
                   ) -> Tuple[torch.Tensor, Dict]:
    """(table, opt_state) of the sparse-rows step on ``device``."""
    return (tree_from_numpy(table_np, device),
            tree_from_numpy(opt_state_np, device))


def to_numpy(table: torch.Tensor, opt_state: Dict) -> Tuple[np.ndarray, Dict]:
    """The reverse of ``from_jax_state``."""
    return tree_to_numpy(table), tree_to_numpy(opt_state)


def train_state_from_numpy(step: int, params_np, opt_state_np,
                           device="cuda"):
    """The port's ``train.trainer.TrainState`` from a step and numpy
    copies of a params tree and its optimizer state (e.g.
    ``jax.device_get`` of the reference's ``TrainState`` fields)."""
    from repro_torch.train.trainer import TrainState
    return TrainState(step=int(step),
                      params=tree_from_numpy(params_np, device),
                      opt_state=tree_from_numpy(opt_state_np, device))


def train_state_to_numpy(state) -> Tuple[int, Dict, Dict]:
    """``(step, params, opt_state)`` of a ``TrainState`` as numpy trees."""
    return (int(state.step), tree_to_numpy(state.params),
            tree_to_numpy(state.opt_state))
