"""The executable ``Plan``: per-leaf compression assignments and glue.

Counterpart of ``repro.plan.plan``; a plan is what the allocator emits:

* ``store_tree()``: the rule-based ``StoreTree`` executing the plan,
  every sketched leaf pinned to explicit ``CountSketchStore`` /
  ``CountMinStore`` specs (``leaf_seed`` included), rank-1 leaves to
  ``Rank1Store``, the rest dense;
* ``make_optimizer()``: ``adam_from_stores(lr, store_tree())``;
* ``specs()``: the exact ``SketchSpec`` of each sketched path and moment;
* ``fold()``: the plan after a Hokusai fold (every width halved), the
  mirror of ``checkpoint.store.fold_sketches`` on the state;
* ``to_json()`` / ``from_json()``: the manifest form, the reference's
  dict key for key, so a plan either package writes loads in the other;
* ``table()`` / ``shard_table()``: the human-readable tables.

A plan with ``sketch_shards > 1`` stamps its stores and specs with the
sharding: the sparse step runs each shard's slabs
(``train.steps.make_sparse_embedding_step(sketch_shards=)``), and
``make_optimizer``'s dense path runs the full tensors on one device, for
which sharding is placement only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import sketch as cs
from repro_torch.core.optimizers import SketchHParams, adam_from_stores
from repro_torch.core.stores import (CountMinStore, CountSketchStore,
                                     DenseStore, Rank1Store, StoreTree,
                                     leaf_seed)
from repro_torch.core.transforms import Transform

MODE_DENSE = "dense"
MODE_SKETCH = "sketch"
MODE_RANK1 = "rank1"

_PLAN_VERSION = 1


class InfeasibleBudgetError(ValueError):
    """The budget is below the plan floor (cheapest feasible assignment)."""

    def __init__(self, budget: int, floor: int):
        super().__init__(
            f"aux budget {budget:,} B is below the plan floor {floor:,} B "
            f"(cheapest assignment: every compressible leaf at its smallest "
            f"mode, everything else dense)")
        self.budget = int(budget)
        self.floor = int(floor)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf's assignment.  ``bytes_m``/``bytes_v`` are the exact aux
    bytes of the 1st/2nd-moment state this assignment allocates."""

    path: str
    shape: Tuple[int, ...]
    dtype: str                  # parameter dtype (dense/rank-1 m buffers)
    mode: str                   # dense | sketch | rank1
    depth: int = 0              # sketch only
    width: int = 0              # sketch only
    bytes_m: int = 0
    bytes_v: int = 0
    predicted_error: float = 0.0

    @property
    def nbytes(self) -> int:
        return self.bytes_m + self.bytes_v


@dataclasses.dataclass(frozen=True)
class Plan:
    leaves: Tuple[LeafPlan, ...]
    budget_bytes: int
    width_multiple: int = 256
    sketch_dtype: str = "float32"
    seed: int = 0
    track_first_moment: bool = True
    sketch_first_moment: bool = True
    # kernel backend of every sketched leaf's fused ``update_read`` (and
    # of the sparse-rows step its stores feed): 'ref' | 'xla' | 'tiled' |
    # 'auto'; None = the composed form.  An execution knob, not state
    # layout: plans differing only here hold interchangeable states.
    backend: Optional[str] = None
    # model-parallel sketch sharding: every sketched leaf split into
    # ``sketch_shards`` equal (depth, local_width, dim) slabs, the budget
    # enforced per device (``predicted_aux_bytes`` stays the total);
    # 'hash' layout changes the hash family, so it is state layout.
    sketch_shards: int = 1
    shard_layout: str = "width"

    # -- accounting ---------------------------------------------------------
    @property
    def predicted_aux_bytes(self) -> int:
        return sum(l.nbytes for l in self.leaves)

    @property
    def predicted_aux_bytes_per_device(self) -> int:
        """One device's share: sketch state splits into ``sketch_shards``
        equal slabs; dense/rank-1 state is replicated (full cost on every
        device).  Equals ``predicted_aux_bytes`` when unsharded."""
        s = max(int(self.sketch_shards), 1)
        total = 0
        for l in self.leaves:
            if l.mode == MODE_SKETCH and s > 1:
                total += -(-l.bytes_m // s) + -(-l.bytes_v // s)
            else:
                total += l.nbytes
        return total

    @property
    def predicted_error(self) -> float:
        return sum(l.predicted_error for l in self.leaves)

    def leaf(self, path: str) -> Optional[LeafPlan]:
        for l in self.leaves:
            if l.path == path:
                return l
        return None

    def n_by_mode(self) -> Dict[str, int]:
        out = {MODE_DENSE: 0, MODE_SKETCH: 0, MODE_RANK1: 0}
        for l in self.leaves:
            out[l.mode] += 1
        return out

    # -- executable surface -------------------------------------------------
    def _leaf_spec(self, l: "LeafPlan", *, signed: bool) -> cs.SketchSpec:
        spec = cs.SketchSpec(depth=int(l.depth), width=int(l.width),
                             dim=int(l.shape[1]), signed=signed,
                             seed=leaf_seed(l.path, self.seed),
                             dtype=self.sketch_dtype)
        if self.sketch_shards > 1:
            spec = dataclasses.replace(spec, shards=int(self.sketch_shards),
                                       layout=self.shard_layout)
        return spec

    def store_tree(self, cleaning=None) -> StoreTree:
        """The per-path ``StoreTree`` executing this plan: exact-path
        rules with explicit specs (serialisable; rides in checkpoint
        manifests).  ``cleaning`` installs the Count-Min cleaning hook on
        every sketched 2nd moment."""
        track = self.track_first_moment
        default_m = DenseStore() if track else None
        rules = []
        for l in self.leaves:
            if l.mode == MODE_SKETCH:
                if track and self.sketch_first_moment:
                    m = CountSketchStore(spec=self._leaf_spec(l, signed=True),
                                         shape=l.shape, backend=self.backend)
                else:
                    m = default_m
                v = CountMinStore(spec=self._leaf_spec(l, signed=False),
                                  shape=l.shape, cleaning=cleaning,
                                  backend=self.backend)
                if self.sketch_shards > 1:
                    # the specs carry the sharding already; the factory
                    # fields get it too, so the JSON round-trips it
                    v = v.with_sharding(self.sketch_shards,
                                        self.shard_layout)
                    if isinstance(m, CountSketchStore):
                        m = m.with_sharding(self.sketch_shards,
                                            self.shard_layout)
                rules.append((l.path, m, v))
            elif l.mode == MODE_RANK1:
                rules.append((l.path, default_m, Rank1Store()))
        return StoreTree(rules=tuple(rules), default_m=default_m,
                         default_v=DenseStore())

    def with_backend(self, backend: Optional[str]) -> "Plan":
        """The same plan pinned to kernel ``backend`` (None = composed
        fallback).  State layout (specs, seeds, widths, bytes) is
        untouched, so checkpointed states restore across this change."""
        return dataclasses.replace(self, backend=backend)

    def with_sharding(self, shards: int, layout: str = "width") -> "Plan":
        """The same assignment laid out over ``shards`` sketch shards.
        Byte totals are unchanged — sharding splits
        them across devices; ``predicted_aux_bytes_per_device`` reflects
        the split.  Every sketched width must divide into equal slabs."""
        shards = int(shards)
        if shards < 1:
            raise ValueError("sketch shards must be >= 1")
        if layout not in ("width", "hash"):
            raise ValueError(f"unknown shard layout {layout!r} "
                             f"(expected 'width' or 'hash')")
        if shards > 1:
            for l in self.leaves:
                if l.mode == MODE_SKETCH and l.width % shards != 0:
                    raise ValueError(
                        f"width {l.width} at {l.path} does not divide "
                        f"into {shards} equal slabs")
        return dataclasses.replace(self, sketch_shards=shards,
                                   shard_layout=layout)

    def make_optimizer(self, lr=1e-3, *, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, cleaning=None,
                       base_hparams: Optional[SketchHParams] = None,
                       backend: Optional[str] = None) -> Transform:
        """``adam_from_stores(lr, self.store_tree())`` in the ``{"step",
        "m", "v"}`` layout.  ``base_hparams`` keeps the execution knobs
        (dense_chunk, lazy, strict_paper); ``backend`` overrides the
        plan's own for this optimizer: every sketched leaf then runs its
        fused ``update_read`` through that kernel backend ('auto':
        ``tiled``, B3, on a card) instead of the composed chunked form.
        A sharded plan's dense path runs the full tensors here, so B3
        runs as for an unsharded one."""
        plan = self if backend is None else self.with_backend(backend)
        hp = base_hparams if base_hparams is not None else SketchHParams()
        return adam_from_stores(
            lr, plan.store_tree(cleaning=cleaning),
            b1=(0.0 if not self.track_first_moment else b1), b2=b2, eps=eps,
            dense_chunk=hp.dense_chunk, lazy=hp.lazy,
            strict_paper=hp.strict_paper)

    def specs(self) -> Dict[str, Dict[str, cs.SketchSpec]]:
        """Exact per-path SketchSpecs ({'m': ..., 'v': ...}) derived the
        same way the optimizer's stores derive them (seed included)."""
        out: Dict[str, Dict[str, cs.SketchSpec]] = {}
        for l in self.leaves:
            if l.mode != MODE_SKETCH:
                continue
            d: Dict[str, cs.SketchSpec] = {}
            if self.track_first_moment and self.sketch_first_moment:
                d["m"] = self._leaf_spec(l, signed=True)
            d["v"] = self._leaf_spec(l, signed=False)
            out[l.path] = d
        return out

    # -- elastic fold -------------------------------------------------------
    def fold(self) -> "Plan":
        """The plan after a Hokusai fold: every sketch width halves (the
        spec-level mirror of ``checkpoint.store.fold_sketches`` on the
        state).  Collision error roughly doubles (CMS error ∝ 1/width);
        dense and rank-1 leaves are untouched."""
        new = []
        for l in self.leaves:
            if l.mode != MODE_SKETCH:
                new.append(l)
                continue
            if l.width % 2 != 0:
                raise ValueError(f"fold requires an even width at {l.path}")
            if (self.sketch_shards > 1
                    and (l.width // 2) % self.sketch_shards != 0):
                raise ValueError(
                    f"folded width {l.width // 2} at {l.path} does not "
                    f"divide into {self.sketch_shards} equal slabs — "
                    f"re-plan before folding below the shard count")
            bm, bv = l.bytes_m, l.bytes_v
            if self.track_first_moment and self.sketch_first_moment:
                bm //= 2
            bv //= 2
            new.append(dataclasses.replace(
                l, width=l.width // 2, bytes_m=bm, bytes_v=bv,
                predicted_error=l.predicted_error * 2.0))
        return dataclasses.replace(self, leaves=tuple(new))

    # -- serialization ------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        out = {
            "version": _PLAN_VERSION,
            "budget_bytes": int(self.budget_bytes),
            "width_multiple": int(self.width_multiple),
            "sketch_dtype": self.sketch_dtype,
            "seed": int(self.seed),
            "track_first_moment": self.track_first_moment,
            "sketch_first_moment": self.sketch_first_moment,
            "backend": self.backend,
            "leaves": [{
                "path": l.path, "shape": list(l.shape), "dtype": l.dtype,
                "mode": l.mode, "depth": int(l.depth), "width": int(l.width),
                "bytes_m": int(l.bytes_m), "bytes_v": int(l.bytes_v),
                "predicted_error": float(l.predicted_error),
            } for l in self.leaves],
        }
        # emitted only when sharded, so unsharded manifests stay
        # byte-identical to every earlier version
        if self.sketch_shards != 1 or self.shard_layout != "width":
            out["sketch_shards"] = int(self.sketch_shards)
            out["shard_layout"] = self.shard_layout
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Plan":
        if d.get("version") != _PLAN_VERSION:
            raise ValueError(f"unknown plan version {d.get('version')!r}")
        leaves = tuple(LeafPlan(
            path=e["path"], shape=tuple(int(s) for s in e["shape"]),
            dtype=e["dtype"], mode=e["mode"], depth=int(e["depth"]),
            width=int(e["width"]), bytes_m=int(e["bytes_m"]),
            bytes_v=int(e["bytes_v"]),
            predicted_error=float(e["predicted_error"]),
        ) for e in d["leaves"])
        return cls(leaves=leaves, budget_bytes=int(d["budget_bytes"]),
                   width_multiple=int(d["width_multiple"]),
                   sketch_dtype=d["sketch_dtype"], seed=int(d["seed"]),
                   track_first_moment=bool(d["track_first_moment"]),
                   sketch_first_moment=bool(d["sketch_first_moment"]),
                   backend=d.get("backend"),
                   sketch_shards=int(d.get("sketch_shards", 1)),
                   shard_layout=d.get("shard_layout", "width"))

    # -- display ------------------------------------------------------------
    def table(self) -> str:
        """Human-readable plan table.
        ``cells`` is the sketch cell-storage dtype; ``aux bytes`` are the
        exact per-leaf bytes AT that dtype (int8 rows include their
        per-block f32 scale overhead, via ``SketchSpec.nbytes``)."""
        rows = [("path", "shape", "mode", "depth×width", "cells",
                 "aux bytes", "pred. err")]
        for l in sorted(self.leaves, key=lambda x: -x.nbytes):
            dw = f"{l.depth}×{l.width}" if l.mode == MODE_SKETCH else "-"
            cells = self.sketch_dtype if l.mode == MODE_SKETCH else "-"
            rows.append((l.path, "×".join(str(s) for s in l.shape), l.mode,
                         dw, cells, f"{l.nbytes:,}",
                         f"{l.predicted_error:.2e}" if l.predicted_error
                         else "0"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        counts = self.n_by_mode()
        lines.append(
            f"TOTAL predicted {self.predicted_aux_bytes:,} B "
            f"<= budget {self.budget_bytes:,} B  "
            f"({counts[MODE_SKETCH]} sketch / {counts[MODE_RANK1]} rank1 / "
            f"{counts[MODE_DENSE]} dense)")
        if self.sketch_shards > 1:
            lines.append(
                f"SHARDED ×{self.sketch_shards} ({self.shard_layout} "
                f"layout): {self.predicted_aux_bytes_per_device:,} B "
                f"per device <= budget (budget is per-device)")
        return "\n".join(lines)

    def shard_table(self) -> str:
        """Per-shard byte table — what each device of the model axis
        holds when ``sketch_shards > 1``.
        Slabs are equal by construction (width % shards == 0), so one
        per-shard column covers all shards; dense/rank-1 rows replicate."""
        s = max(int(self.sketch_shards), 1)
        rows = [("path", "mode", "total bytes", f"bytes/shard (×{s})")]
        repl = 0
        for l in sorted(self.leaves, key=lambda x: -x.nbytes):
            if l.mode == MODE_SKETCH:
                per = -(-l.bytes_m // s) + -(-l.bytes_v // s)
                rows.append((l.path, f"sketch/{self.shard_layout}",
                             f"{l.nbytes:,}", f"{per:,}"))
            else:
                repl += l.nbytes
                rows.append((l.path, l.mode, f"{l.nbytes:,}",
                             f"{l.nbytes:,} (replicated)"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(
            f"PER-DEVICE {self.predicted_aux_bytes_per_device:,} B  "
            f"(total {self.predicted_aux_bytes:,} B across {s} shards; "
            f"{repl:,} B replicated)")
        return "\n".join(lines)
