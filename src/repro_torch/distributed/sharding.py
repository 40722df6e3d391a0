"""Placement rules: which block of each tensor a replica of a mesh holds.

Counterpart of ``repro.distributed.sharding``'s rule functions, which
the reference hands to ``jax.jit`` and ``device_put`` as
``PartitionSpec`` trees.  Here a spec is a plain tuple with one entry a
dimension: an axis name, a tuple of axis names (the first the major
one) or None; trailing Nones are dropped, so ``()`` is replicated.  The
rules are the reference's, entry for entry:

  * **missing axes drop out**: a rule may name "pod"; on a mesh without
    that axis the dimension is not split;
  * **divisibility fallback**: a dimension the named axis does not
    divide is not split (qwen2-0.5b's 14 heads on a 16-way 'model' axis
    replicate its attention weights);
  * layer-stacked leaves (under ``layers/``) get a leading None;
  * ZeRO-1 (``zero1_spec``), sketch tensors (``sketch_spec``: width over
    'data' and dim over 'model', or a sharded sketch's width slabs over
    'model'), the optimizer state's tree (``opt_specs_for_state``), the
    batch (``batch_spec`` over ``dp_axes``) and a sharded sparse state
    (``sketch_state_specs``).

A mesh is anything with ``axis_names`` and sizes: a ``ReplicaMesh``
(``shape``), ``process_group_mesh``'s ``GroupMesh``, a ``Grid`` (a plain
description, the launcher's grid over its processes) or an object with
the reference's ``devices.shape``.  ``local_block(x, spec, mesh,
coords)`` is one replica's block of a global tensor, the counterpart of
``device_put`` with a ``NamedSharding``; ``global_leaf`` gathers it back
over the mesh's axes (``global_tree`` a whole tree).  A ``Placement``
(spec tree, mesh, this replica's coordinates) is what
``checkpoint.store.save`` and ``restore`` take as ``shardings``.

The reference's mesh and tracing helpers have no counterpart here
(``make_mesh_compat``, ``shard_map_compat``, ``named``,
``active_mesh``, ``current_mesh``, ``manual_collectives``,
``dp_sparse_wrap``, ``sharded_sparse_wrap``, ``shard_map_unchecked``,
``constraint``): a port step is already one replica's body, its
collectives passed in as ``dp_axis``/``shard_axis``, so there is no
program to trace under a mesh and no sharding to constrain.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import _flatten, _rebuild

Spec = Tuple[Any, ...]

# (path regex, per-dim axis template); 'fsdp:<axis>' entries apply only
# when the config opts into fsdp.  Matched against the path suffix.
RULES: Sequence[Tuple[str, Tuple[Any, ...]]] = (
    # vocab tables: row (vocab) sharded over model
    (r"(tok_embed|lm_head)/table$", ("model", "fsdp:data")),
    # attention
    (r"attn/wq$", (None, "model")),
    (r"attn/wk$", (None, "model")),
    (r"attn/wv$", (None, "model")),
    (r"attn/wo$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    (r"(self_attn|cross_attn)/wq$", (None, "model")),
    (r"(self_attn|cross_attn)/wk$", (None, "model")),
    (r"(self_attn|cross_attn)/wv$", (None, "model")),
    (r"(self_attn|cross_attn)/wo$", ("model", None)),
    # dense FFN
    (r"ffn/w_gate$", (None, "model")),
    (r"ffn/w_up$", (None, "model")),
    (r"ffn/w_down$", ("model", None)),
    (r"mlp/w1$", (None, "model")),
    (r"mlp/w2$", ("model", None)),
    # MoE (expert_sharding='ep'); the 'tp' override is in spec_for
    (r"ffn/router$", (None, None)),
    (r"ffn/w_gate3$", ("model", "fsdp:pod", "fsdp:data")),   # (E, d, f)
    (r"ffn/w_up3$", ("model", "fsdp:pod", "fsdp:data")),
    (r"ffn/w_down3$", ("model", "fsdp:data", "fsdp:pod")),   # (E, f, d)
    (r"ffn/shared/w_gate$", (None, "model")),
    (r"ffn/shared/w_up$", (None, "model")),
    (r"ffn/shared/w_down$", ("model", None)),
    # RWKV6
    (r"tm/w[rkvg]$", (None, "model")),
    (r"tm/wo$", ("model", None)),
    (r"tm/w_[AB]$", (None, None)),
    (r"tm/u$", (None, None)),
    (r"cm/wk$", (None, "model")),
    (r"cm/wv$", ("model", None)),
    (r"cm/wr$", (None, "model")),
    # Mamba2
    (r"[zx]_proj$", (None, "model")),    # (d, d_inner): head-sharded
    (r"bc_proj$", (None, None)),         # (d, 2n): n is tiny, replicate
    (r"dt_proj$", (None, "model")),      # (d, heads)
    (r"conv_w_x$", (None, "model")),     # (K, di) depthwise
    (r"conv_b_x$", ("model",)),
    (r"conv_w_bc$", (None, None)),
    (r"conv_b_bc$", (None,)),
    (r"out_proj$", ("model", None)),     # (d_inner, d)
    (r"(A_log|dt_bias|D)$", ("model",)),  # per-head scalars
    (r"gn$", ("model",)),                # group-norm scale over d_inner
)

_REPLICATE = re.compile(r"(ln\d?|norm|scale|bias|mix_|w_base|router)")


@dataclasses.dataclass(frozen=True)
class Grid:
    """A plain mesh description: axis sizes and names, no devices and no
    collectives.  The launcher's grid over its processes, rank ``r`` at
    ``coords(r)`` in row-major order (the counterpart of
    ``launch.mesh.make_host_mesh``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"a grid needs one name an axis, got "
                             f"{self.shape} and {self.axis_names}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of any mesh (see the module docstring)."""
    shape = getattr(mesh, "shape", None)
    if shape is None:
        shape = mesh.devices.shape
    return dict(zip(mesh.axis_names, (int(n) for n in shape)))


def _axis_size(mesh, name: str) -> Optional[int]:
    return axis_sizes(mesh).get(name)


def _resolve_dim(entry, dim: int, mesh, fsdp: bool):
    """Template entry -> mesh axis name or None (with fallbacks)."""
    if entry is None:
        return None
    if isinstance(entry, str) and entry.startswith("fsdp:"):
        if not fsdp:
            return None
        entry = entry.split(":", 1)[1]
    size = _axis_size(mesh, entry)
    if size is None or dim % size != 0:
        return None
    return entry


def spec_of(axes) -> Spec:
    """The canonical spec of a list of entries, as ``PartitionSpec``
    normalizes it: a one-name tuple is the name, an empty one None, and
    trailing Nones are dropped."""
    axes = [(a[0] if len(a) == 1 else a or None)
            if isinstance(a, tuple) else a for a in axes]
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def map_leaves(fn, tree):
    """``tree``'s structure with ``fn(path, leaf)`` at each leaf (paths
    as ``checkpoint.store`` writes them)."""
    return _rebuild(tree, iter(fn(p, x) for p, x in _flatten(tree)))


def spec_for(path: str, shape: Tuple[int, ...], mesh, *,
             fsdp: bool = False, expert_sharding: str = "ep") -> Spec:
    """The spec of one parameter leaf."""
    if _REPLICATE.search(path.rsplit("/", 1)[-1]) and "proj" not in path:
        return ()
    stacked = "/layers/" in f"/{path}" or path.startswith(
        ("layers/", "enc_layers/", "dec_layers/"))
    tpl = next((t for pat, t in RULES if re.search(pat, path)), None)
    eff_shape = shape[1:] if stacked else shape
    if tpl is None or len(tpl) != len(eff_shape):
        # rank-3 MoE leaves match the rank-2 ffn rules by name
        if re.search(r"ffn/w_(gate|up|down)$", path) and len(eff_shape) == 3:
            name = path.rsplit("/", 1)[-1]
            if expert_sharding == "ep":
                tpl = dict(w_gate=("model", "fsdp:pod", "fsdp:data"),
                           w_up=("model", "fsdp:pod", "fsdp:data"),
                           w_down=("model", "fsdp:data", "fsdp:pod"))[name]
            else:  # per-expert TP on d_ff
                tpl = dict(w_gate=(None, None, "model"),
                           w_up=(None, None, "model"),
                           w_down=(None, "model", None))[name]
        else:
            tpl = (None,) * len(eff_shape)
    axes = [_resolve_dim(entry, dim, mesh, fsdp)
            for entry, dim in zip(tpl, eff_shape)]
    if stacked:
        axes = [None] + axes
    return spec_of(axes)


def param_specs(params_shape, mesh, *, fsdp: bool = False,
                expert_sharding: str = "ep"):
    """The spec tree of a params (or ``meta``) tree."""
    return map_leaves(lambda path, x: None if x is None else spec_for(
        path, tuple(x.shape), mesh, fsdp=fsdp,
        expert_sharding=expert_sharding), params_shape)


def zero1_spec(param_spec: Spec, shape: Tuple[int, ...], mesh,
               axis: str = "data") -> Spec:
    """ZeRO-1: add ``axis`` on the first unsharded divisible dim."""
    size = _axis_size(mesh, axis)
    if size is None:
        return tuple(param_spec)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for e in entries if e
            for a in ((e,) if isinstance(e, str) else e)}
    if axis in used:
        return tuple(param_spec)
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0 and dim >= size:
            entries[i] = axis
            break
    return spec_of(entries)


def sketch_spec(mesh, shape: Tuple[int, int, int], *, shards: int = 1,
                shard_axis: str = "model") -> Spec:
    """A (depth, width, dim) sketch tensor: a sharded sketch
    (``shards > 1``) keeps its width slabs on ``shard_axis`` and dim
    whole; a replicated one spreads width over 'data' and dim over
    'model' where they divide."""
    _, w, d = shape
    if shards > 1:
        size = _axis_size(mesh, shard_axis)
        if size and w % size == 0:
            return (None, shard_axis)
    data, model = _axis_size(mesh, "data"), _axis_size(mesh, "model")
    return spec_of([None,
                   "data" if data and w % data == 0 else None,
                   "model" if model and d % model == 0 else None])


# moment tags an optimizer state may carry: 'm'/'v', and the DP rule's
# error-feedback 'residual' (in the v geometry)
_MOMENT_TAGS = ("m", "v", "residual")


def _looks_like_sketch(shape: Tuple[int, ...]) -> bool:
    """(depth <= 8, width, dim) rank-3 tensors."""
    return len(shape) == 3 and shape[0] <= 8


def opt_specs_for_state(state_shape, params_shape, mesh, *,
                        fsdp: bool = False, expert_sharding: str = "ep",
                        store_tree=None, strict: bool = True):
    """The spec tree of an optimizer state, paths resolved in the
    ``chain``/store state layout:

      * leading integer components (``chain`` indices) are stripped;
      * a dense moment leaf (its param's shape) takes the param's spec
        plus ZeRO-1 'data' on the first free divisible dim;
      * a sketch leaf takes ``sketch_spec``: exactly when a
        ``store_tree`` resolves its param path to a sketch-backed store
        of this shape (a sharded store keeps its slabs on 'model'),
        else by structure (rank 3, depth <= 8, dim == the param's
        trailing dim, or a bare single-table ``m``/``v``/``residual``);
      * rank-1 factors (``.r``/``.c``), int8 ``.scales`` and scalars
        replicate.

    ``strict``: a sketch-like moment leaf no rule places raises, and so
    does a sharded sketch on a mesh whose 'model' axis does not divide
    its width, instead of replicating."""
    param_shapes = {p: tuple(x.shape) for p, x in _flatten(params_shape)
                    if x is not None}
    resolved = (store_tree.sketch_state_specs(param_shapes)
                if store_tree is not None else {})

    def leaf(path, x):
        if x is None or not hasattr(x, "shape") or len(x.shape) == 0:
            return ()
        shape = tuple(x.shape)
        parts = [p for p in path.split("/") if p]
        while parts and parts[0].isdigit():      # chain tuple indices
            parts.pop(0)
        if not parts:
            return ()
        tag, rest = parts[0], parts[1:]
        if tag not in _MOMENT_TAGS:
            return ()                            # step counters, scalars
        if rest and rest[-1].lstrip(".") in ("r", "c") and len(shape) == 1:
            return ()                            # rank-1 factors
        if rest and rest[-1].lstrip(".") == "scales" and len(shape) == 2:
            return ()                            # int8 block scales
        if rest and rest[-1].lstrip(".") == "cells" and len(shape) == 3:
            rest = rest[:-1]
        sub = "/".join(rest)
        pshape = param_shapes.get(sub)
        if pshape == shape:
            base = spec_for(sub, shape, mesh, fsdp=fsdp,
                            expert_sharding=expert_sharding)
            return zero1_spec(base, shape, mesh)
        if not sub and _looks_like_sketch(shape):
            return sketch_spec(mesh, shape)      # bare single-table state
        if store_tree is not None and sub:
            want = resolved.get(("v" if tag == "residual" else tag, sub))
            if want is not None and tuple(want.shape) == shape:
                if want.shards > 1:
                    size = _axis_size(mesh, "model")
                    if strict and (not size or shape[1] % size != 0):
                        raise ValueError(
                            f"optimizer-state leaf {path!r} resolves to a "
                            f"{want.shards}-shard sketch but the mesh has "
                            f"no 'model' axis dividing width {shape[1]} "
                            f"(axes {axis_sizes(mesh)}); "
                            f"refusing to silently replicate sharded "
                            f"sketch state")
                return sketch_spec(mesh, shape, shards=want.shards)
        elif _looks_like_sketch(shape) and pshape is not None \
                and len(pshape) == 2 and shape[2] == pshape[1]:
            return sketch_spec(mesh, shape)
        if strict and _looks_like_sketch(shape) and (
                not sub or pshape is None or len(pshape) == 2):
            raise ValueError(
                f"optimizer-state leaf {path!r} with sketch-like shape "
                f"{shape} matched no sharding rule (param shape "
                f"{pshape}); refusing to silently replicate sketch state "
                f"— pass the run's StoreTree or fix the rules")
        return ()

    return map_leaves(leaf, state_shape)


def dp_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The data-parallel axis group ('pod', 'data' where present) that
    evenly divides ``batch``: the longest prefix, else fewer axes ('pod'
    dropped first), else none."""
    cand = [a for a in ("pod", "data") if _axis_size(mesh, a)]
    while cand:
        size = 1
        for a in cand:
            size *= _axis_size(mesh, a)
        if batch % size == 0 and batch >= size:
            return tuple(cand)
        cand.pop(0)
    return ()


def batch_spec(mesh, shape: Tuple[int, ...], *,
               seq_axis: Optional[int] = None) -> Spec:
    """Dim 0 over the DP axis group; optionally dim ``seq_axis`` over
    'model' (sequence parallelism for caches)."""
    dp = dp_axes(mesh, shape[0])
    axes: list = [dp if dp else None] + [None] * (len(shape) - 1)
    model = _axis_size(mesh, "model")
    if seq_axis is not None and model and shape[seq_axis] % model == 0:
        axes[seq_axis] = "model"
    return spec_of(axes)


def sketch_state_specs(state, shard_axis: str = "model"):
    """The spec tree of a sparse-rows state whose sketches are SHARDED:
    every rank-3 (depth, width, dim) leaf (m, v, residual) has its width
    over ``shard_axis``; everything else replicates."""
    return map_leaves(lambda _p, x: (None, shard_axis) if hasattr(
        x, "shape") and len(x.shape) == 3 else (), state)


# ---------------------------------------------------------------------------
# Blocks of a global tensor
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coords(mesh, coords) -> Dict[str, int]:
    if coords is None:
        coords = mesh.coords
    if isinstance(coords, dict):
        return dict(coords)
    return dict(zip(mesh.axis_names, (int(c) for c in coords)))


def _block_index(spec: Spec, dim: int, mesh, coords) -> Tuple[int, int]:
    """(blocks, index) of dim ``dim`` under ``spec`` for the replica at
    ``coords``: the entry's axes in mixed radix, the first the major."""
    sizes, at = axis_sizes(mesh), _coords(mesh, coords)
    entry = spec[dim] if dim < len(spec) else None
    n, idx = 1, 0
    for a in _entry_axes(entry):
        if a not in sizes:
            raise ValueError(f"spec {spec} names axis {a!r}, which the mesh "
                             f"{sizes} lacks")
        n, idx = n * sizes[a], idx * sizes[a] + at[a]
    return n, idx


def local_block(x, spec: Spec, mesh, coords=None) -> torch.Tensor:
    """The block of the global ``x`` (a tensor or numpy array) that the
    replica at ``coords`` (a tuple in ``mesh.axis_names`` order or a
    dict; default ``mesh.coords``) holds under ``spec``, as a new
    contiguous tensor: the steps write their state in place, so a block
    never shares memory with ``x``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    spec = tuple(spec or ())
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{tuple(t.shape)} tensor has dims")
    for dim in range(len(spec)):
        n, idx = _block_index(spec, dim, mesh, coords)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does "
                             f"not split into {n} blocks (spec {spec})")
        blk = t.shape[dim] // n
        t = t.narrow(dim, idx * blk, blk)
    return t.clone(memory_format=torch.contiguous_format)


def global_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The inverse of ``local_block``, a collective: every replica's
    block gathered over the axes of ``spec`` (``mesh.axis(name)
    .all_gather``) into the global tensor, on every replica."""
    spec = tuple(spec or ())
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):     # the minor axis first
            parts = mesh.axis(a).all_gather(t)
            t = torch.cat(list(parts.unbind(0)), dim=dim)
    return t


def global_tree(tree, placement: "Placement"):
    """``tree`` with each placed leaf gathered into its global tensor
    (``global_leaf``), a collective every replica makes in the same
    order; the other leaves as they are."""
    out = []
    for (_path, leaf), spec in zip(_flatten(tree),
                                   placement.spec_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and spec:
            leaf = global_leaf(leaf, spec, placement.mesh)
        out.append(leaf)
    return _rebuild(tree, iter(out))


@dataclasses.dataclass
class Placement:
    """Where a tree lives: its spec tree (the tree's structure, a spec at
    each leaf; None replicates), the mesh and this replica's
    coordinates (None: ``mesh.coords``, read when used)."""

    specs: Any
    mesh: Any
    coords: Any = None

    def spec_leaves(self, like) -> list:
        """The specs of ``like``'s leaves, in ``_flatten`` order."""
        return _spec_leaves(self.specs, like)

    def is_writer(self) -> bool:
        """Whether this replica is the one at the mesh's origin."""
        return not any(_coords(self.mesh, self.coords).values())


def _spec_leaves(specs, like) -> list:
    """``specs`` walked along ``like``'s structure: the value at each of
    ``like``'s leaves (specs are tuples, so they cannot be flattened on
    their own)."""
    if specs is None:
        return [None] * len(_flatten(like))
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _spec_leaves(specs.get(k), like[k])]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return [s for f in like._fields
                for s in _spec_leaves(getattr(specs, f), getattr(like, f))]
    if isinstance(like, (list, tuple)):
        return [s for i, v in enumerate(like)
                for s in _spec_leaves(specs[i], v)]
    return [specs]


def place(tree, placement: Placement, device="cuda"):
    """``tree`` (global leaves) with each placed leaf replaced by this
    replica's block of it on ``device``; the other leaves move to
    ``device`` as they are (a host int counter stays on the host)."""
    out = []
    for (_path, leaf), spec in zip(_flatten(tree),
                                   placement.spec_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
            if spec:
                leaf = local_block(leaf, spec, placement.mesh,
                                   placement.coords)
            leaf = leaf.to(device)
        out.append(leaf)
    return _rebuild(tree, iter(out))
