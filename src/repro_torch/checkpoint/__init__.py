"""Atomic, resumable checkpoints in the reference's format."""
from repro_torch.checkpoint.store import (  # noqa: F401
    default_is_sketch, fold_predicate_from_manifest, fold_sketches,
    is_sketch_from_store_tree, latest_step, read_manifest, restore, save)
