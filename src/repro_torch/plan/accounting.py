"""Byte accounting of optimizer moments, predicted and measured.

Counterpart of ``repro.plan.accounting``.  Predictions are exact by
construction: sketch bytes come from ``SketchSpec.nbytes()``, dense
moments from the leaf's own shape and dtype, rank-1 factors from the f32
(n,) + (d,) vectors of a ``Rank1Moment``.  ``measure_aux_bytes`` sums a
real state, so a prediction equals the measurement unless an allocation
changes without its predictor.  "Aux" means the ``m``/``v`` trees only:
the step counter and the parameters are never counted.

The reference counts an optimizer's bytes with ``jax.eval_shape`` of its
``init``; the port runs the real ``init`` on ``torch.device("meta")``,
which allocates nothing.  ``params_like`` is a tree of tensors (any
device) or of ``ShapeDtype`` records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import sketch as cs
from repro_torch.core.optimizers import SketchHParams
from repro_torch.core.partition import PolicyFn, leaf_paths, nothing_policy
from repro_torch.core.stores import tree_bytes
from repro_torch.core.transforms import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A parameter leaf's shape and dtype name, with no storage."""
    shape: Tuple[int, ...]
    dtype: str = "float32"


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... from a ``torch.dtype``, a numpy dtype or
    a name."""
    return str(getattr(dtype, "name", dtype)).replace("torch.", "")


def _itemsize(dtype) -> int:
    return getattr(torch, dtype_name(dtype)).itemsize


def _leaf_size(shape: Tuple[int, ...]) -> int:
    size = 1
    for s in shape:
        size *= int(s)
    return size


def meta_params(params_like):
    """``params_like`` as ``meta`` tensors of the same shapes and dtypes."""
    return tree_map_with_path(
        lambda _p, leaf: torch.empty(
            tuple(int(s) for s in leaf.shape),
            dtype=getattr(torch, dtype_name(leaf.dtype)), device="meta"),
        params_like)


def dense_leaf_bytes(shape, dtype, *, track_first_moment: bool = True
                     ) -> Tuple[int, int]:
    """(m, v) bytes of a dense Adam leaf: ``zeros_like(param)`` each."""
    b = _leaf_size(shape) * _itemsize(dtype)
    return (b if track_first_moment else 0, b)


def sketch_leaf_bytes(shape, dtype, depth: int, width: int, *,
                      sketch_dtype="float32", track_first_moment: bool = True,
                      sketch_first_moment: bool = True) -> Tuple[int, int]:
    """(m, v) bytes of a sketched leaf at (depth, width): v a sketch, m a
    sketch (CS-MV), a dense buffer (CS-V) or absent (β₁=0)."""
    n, d = int(shape[0]), int(shape[1])
    sb = cs.SketchSpec(depth=depth, width=width, dim=d,
                       dtype=dtype_name(sketch_dtype)).nbytes()
    if not track_first_moment:
        return 0, sb
    if sketch_first_moment:
        return sb, sb
    return _leaf_size(shape) * _itemsize(dtype), sb


def rank1_leaf_bytes(shape, dtype, *, track_first_moment: bool = True
                     ) -> Tuple[int, int]:
    """(m, v) bytes of an LR-NMF-V leaf: dense m when tracked, f32 (n,) +
    (d,) factors for v."""
    n, d = int(shape[0]), int(shape[1])
    m = _leaf_size(shape) * _itemsize(dtype) if track_first_moment else 0
    return m, (n + d) * 4


def predict_policy_bytes(params_like, *, policy: PolicyFn,
                         hparams: SketchHParams,
                         rank1_policy: PolicyFn = nothing_policy,
                         track_first_moment: bool = True,
                         sketch_first_moment: bool = True) -> int:
    """Aux bytes ``countsketch_adam(policy, rank1_policy, hparams).init``
    allocates for ``params_like``: the real init on the ``meta`` device,
    so the count cannot drift from the optimizer's allocation."""
    from repro_torch.core.optimizers import countsketch_adam
    opt = countsketch_adam(1e-3, policy=policy, rank1_policy=rank1_policy,
                           hparams=hparams,
                           track_first_moment=track_first_moment,
                           sketch_first_moment=sketch_first_moment)
    return measure_aux_bytes(opt.init(meta_params(params_like)))


def measure_aux_bytes(opt_state: Any) -> int:
    """Bytes of the ``m``/``v`` trees of an optimizer state (tensors on
    any device, ``meta`` included; ``QuantState`` and ``Rank1Moment``
    fields counted)."""
    return sum(tree_bytes(opt_state[key]) for key in ("m", "v")
               if key in opt_state)


def dense_budget_bytes(params_like, *, track_first_moment: bool = True) -> int:
    """Aux bytes of the dense Adam baseline."""
    total = 0
    for _, leaf in leaf_paths(params_like):
        m, v = dense_leaf_bytes(tuple(leaf.shape), leaf.dtype,
                                track_first_moment=track_first_moment)
        total += m + v
    return total
