"""Per-parameter compression policy (paper §4: embedding + softmax layers).

Counterpart of ``repro.core.partition``.  The policy decides, for every
parameter leaf, whether its optimizer moments live in a count-sketch or in
a dense same-shape buffer.  Paths are '/'-joined keys into a nested dict
of tensors, e.g. ``tok_embed/table``: the strings the reference builds,
since ``stores.leaf_seed(path)`` seeds the hashes and another string
would address other buckets.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Tuple

PolicyFn = Callable[[str, Tuple[int, ...]], bool]

# Parameter names of the sparse-gradient tables.
SPARSE_TABLE_PATTERN = re.compile(
    r"(tok_embed|lm_head|softmax|embed_out|class_head|expert_table)")

# Below this row count a sketch cannot win: ``sketch.for_param`` floors the
# width at one ``width_multiple`` stripe, so depth x width_multiple x dim
# can exceed the dense rows x dim buffer.
MIN_SKETCH_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class SketchPolicy:
    """Sketch rank-2 (rows, dim) leaves whose path matches ``pattern`` and
    whose row count clears ``min_rows``; ``sketch_experts`` also opts in
    rank-3 MoE expert weights, sketched over (experts*d_in) rows."""

    min_rows: int = MIN_SKETCH_ROWS
    pattern: "re.Pattern" = SPARSE_TABLE_PATTERN
    sketch_experts: bool = False

    def __call__(self, path: str, shape: Tuple[int, ...]) -> bool:
        if len(shape) == 2 and shape[0] >= self.min_rows:
            if self.pattern.search(path):
                return True
        if (self.sketch_experts and len(shape) == 3
                and "expert" in path and shape[0] * shape[1] >= self.min_rows):
            return True
        return False


def nothing_policy(path: str, shape: Tuple[int, ...]) -> bool:
    """Compress nothing: the dense baseline."""
    return False


def everything_policy(path: str, shape: Tuple[int, ...]) -> bool:
    """Compress every rank-2 leaf of at least ``MIN_SKETCH_ROWS`` rows."""
    return len(shape) == 2 and shape[0] >= MIN_SKETCH_ROWS


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """Flatten nested dicts/lists/tuples into ``(path, leaf)`` pairs in
    the reference's order: dict keys sorted, as ``jax.tree_util`` sorts
    them, sequences by position.  ``None`` is an empty subtree, as in
    JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(leaf_paths(child, f"{prefix}/{key}" if prefix else key))
    return out
