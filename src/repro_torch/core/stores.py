"""AuxStore codecs and the StoreTree resolver, f32 cells.

Counterpart of ``repro.core.stores``.  A store is how one optimizer moment
is kept; the protocol is

    store.init(device)              -> state            (zeroed)
    store.accumulate(state, delta, rows=None, scale=1.0)
    store.decay(state, beta)
    store.read(state, rows=None)    -> values           (estimate rows)
    store.update_read(state, delta, beta, ...) -> (state, est)
    store.clean(state, step)        -> state            (cleaning hook)

``update_read`` is the dense path's op: it moves row content to
``beta*content + scale*delta`` and returns the post-step estimate.  The
base default composes decay, accumulate and read; sketch stores use the
paper's linear-estimate form, and with ``backend`` set they run it as one
fused kernel through ``repro_torch.kernels.update_read``.  Its ``step``
keys the stochastic rounding of bf16 and int8 sketch cells
(``quantize.step_seed``); a float32 sketch draws no seed.

  * ``DenseStore``       - the uncompressed same-shape buffer (exact);
  * ``CountSketchStore`` - signed Count-Sketch, median read (momentum,
    Adam's 1st moment);
  * ``CountMinStore``    - unsigned Count-Min, min read, with the paper's
    §4 cleaning as its ``clean`` hook (Adagrad, Adam's 2nd moment);
  * ``StoreTree``        - path -> (m_store, v_store).

Stores are frozen dataclasses that double as factories: ``bind(path,
shape, dtype)`` sizes one leaf's state with the same per-leaf seed
(``leaf_seed``) as the reference, so both packages address the same
buckets.  A sketch store's ``dtype`` names its cells ('float32' |
'bfloat16' | 'int8'); an int8 state is a ``quantize.QuantState``.  Every
state is updated IN PLACE and returned.  ``Rank1Store`` waits for the
planner (ROADMAP A9), ``stats`` for telemetry (A11), the JSON round-trip
for A9.  ``tree_bytes`` counts a state tree's bytes.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import quantize as qz
from repro_torch.core import sketch as cs
from repro_torch.core.cleaning import CleaningSchedule, maybe_clean
from repro_torch.core.sketch import SketchSpec


def leaf_seed(path: str, base_seed: int) -> int:
    """Per-leaf hash seed, the reference's derivation."""
    return (zlib.crc32(path.encode()) ^ (base_seed * 0x9E3779B1)) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class AuxStore:
    """Base codec.  ``accepts(shape)`` is the pre-check ``StoreTree.select``
    uses to leave leaves a store cannot hold on the defaults."""

    kind = "abstract"

    def accepts(self, shape) -> bool:
        return True

    def bind(self, path: str, shape, dtype=None) -> "AuxStore":
        return self

    def update_read(self, state, delta, beta: float = 1.0, *,
                    scale: Optional[float] = None, rows=None, mask=None,
                    read_state=None, strict: bool = False, step=None):
        """Move row content to ``beta*content + scale*delta`` (``scale``
        defaults to ``1-beta``) and return ``(state, estimate)``.  This
        default composes decay, accumulate and read, exact for a dense
        buffer; ``mask`` (rows x 1, 0/1) gates the increment, and
        ``read_state``/``strict``/``step`` only mean something to sketch
        stores."""
        if scale is None:
            scale = 1.0 - beta
        if mask is not None:
            delta = delta * mask
        if beta != 1.0:
            state = self.decay(state, beta)
        state = self.accumulate(state, delta, rows, scale=scale)
        return state, self.read(state, rows)

    def clean(self, state, step):
        """Cleaning hook (paper §4): identity except on ``CountMinStore``."""
        return state


@dataclasses.dataclass(frozen=True)
class DenseStore(AuxStore):
    """The uncompressed baseline: a zero buffer of the leaf's shape and
    (unless ``dtype`` names another) its dtype.  ``rows`` reads and adds
    single rows."""

    dtype: Optional[str] = None                 # None: the leaf's own dtype
    shape: Optional[Tuple[int, ...]] = None     # set by bind()

    kind = "dense"

    def bind(self, path, shape, dtype=None):
        name = self.dtype or str(dtype or torch.float32).replace("torch.", "")
        return dataclasses.replace(self, shape=tuple(int(s) for s in shape),
                                   dtype=name)

    def init(self, device="cuda") -> torch.Tensor:
        return torch.zeros(self.shape, dtype=getattr(torch, self.dtype),
                           device=device)

    def accumulate(self, state, delta, rows=None, *, scale: float = 1.0):
        """Add ``scale*delta`` IN PLACE, at ``rows`` when given (repeated
        rows accumulate in batch order).  An f32 state on CUDA adds its
        rows by B5's run scatter (a 1-D state as (n, 1)), with no
        atomics: the CPU ``index_add_``'s bits on every run.  Other
        dtypes on CUDA sum repeated rows with atomics; the port's steps
        give this store f32 states, or distinct rows."""
        if scale != 1.0:
            delta = scale * delta
        if rows is None:
            return state.add_(delta)
        if state.device.type == "cuda" and state.dtype == torch.float32 \
                and state.dim() >= 1:
            from repro_torch.kernels.cs_update import cs_update
            n, k = state.shape[0], rows.numel()
            cs_update(state.view(1, n, -1),
                      rows.to(torch.int32).reshape(1, k), None,
                      delta.to(torch.float32).reshape(k, -1).contiguous())
            return state
        return state.index_add_(0, rows.long(), delta.to(state.dtype))

    def decay(self, state, beta):
        return state.mul_(beta)

    def read(self, state, rows=None):
        return state if rows is None else state[rows.long()]


@dataclasses.dataclass(frozen=True)
class Rank1Store(AuxStore):
    """The rank-1 (row x col) 2nd moment of the LR-NMF-V baseline: not
    ported yet."""

    kind = "rank1"

    def __post_init__(self):
        raise NotImplementedError(
            "Rank1Store (core/lowrank.py, LR-NMF-V) is not ported yet: it "
            "arrives with the planner, ROADMAP A9")


@dataclasses.dataclass(frozen=True)
class _SketchStoreBase(AuxStore):
    """Shared machinery of the two sketch codecs.  ``compression`` sizes
    the sketch like ``sketch.for_param``; an explicit ``width`` pins it;
    an explicit ``spec`` bypasses sizing.  ``backend`` names the kernel
    backend ('ref' | 'xla' | 'tiled' | 'auto') that runs ``update_read``
    as one fused op; None keeps the composed form."""

    compression: float = 5.0
    depth: int = 3
    width: Optional[int] = None
    width_multiple: int = 256
    seed: int = 0
    dtype: str = "float32"
    identity: bool = False
    shards: int = 1
    shard_layout: str = "width"
    spec: Optional[SketchSpec] = None
    shape: Optional[Tuple[int, int]] = None
    backend: Optional[str] = None

    _signed = True

    def accepts(self, shape) -> bool:
        return len(shape) == 2

    def bind(self, path: str, shape, dtype=None) -> "_SketchStoreBase":
        shape = tuple(int(s) for s in shape)
        if self.spec is not None:
            return self if self.shape is not None \
                else dataclasses.replace(self, shape=shape)
        if len(shape) != 2:
            raise ValueError(f"{type(self).__name__} needs a rank-2 "
                             f"(rows, dim) leaf, got {shape} at {path!r}")
        if self.width is not None:
            spec = SketchSpec(depth=int(self.depth), width=int(self.width),
                              dim=shape[1], signed=self._signed,
                              seed=leaf_seed(path, self.seed),
                              dtype=self.dtype, identity=self.identity)
        else:
            spec = cs.for_param(shape, compression=self.compression,
                                depth=self.depth, signed=self._signed,
                                seed=leaf_seed(path, self.seed),
                                width_multiple=self.width_multiple,
                                dtype=self.dtype, identity=self.identity)
        if self.shards != 1 or self.shard_layout != "width":
            spec = dataclasses.replace(spec, shards=int(self.shards),
                                       layout=self.shard_layout)
        return dataclasses.replace(self, spec=spec, shape=shape)

    def _rows(self, rows, device) -> torch.Tensor:
        if rows is not None:
            return rows
        if self.shape is None:
            raise ValueError("rows=None needs a store bound to a table shape")
        return torch.arange(self.shape[0], dtype=torch.int32, device=device)

    @property
    def cell_dtype_name(self) -> str:
        """'float32' | 'bfloat16' | 'int8', from the bound spec when there
        is one, else the ``dtype`` field."""
        if self.spec is not None:
            return self.spec.cell_dtype_name
        return qz.cell_dtype_name(self.dtype)

    @property
    def scale_block(self) -> int:
        """Buckets per f32 scale of int8 cells."""
        return self.spec.scale_block if self.spec is not None \
            else qz.SCALE_BLOCK

    def init(self, device="cuda"):
        return cs.init(self.spec, device)

    def accumulate(self, state, delta, rows=None, *, scale: float = 1.0):
        if scale != 1.0:
            delta = scale * delta
        return cs.update(self.spec, state,
                         self._rows(rows, cs.device_of(state)), delta)

    def decay(self, state, beta):
        return cs.decay(state, beta)

    def read(self, state, rows=None):
        return cs.query(self.spec, state,
                        self._rows(rows, cs.device_of(state)))

    def _sr_seed(self, step):
        """The step's stochastic-rounding seed for bf16/int8 cells; None
        for float32.  A None ``step`` keeps the step-0 seed."""
        if not self.spec.lowp:
            return None
        return qz.step_seed(self.spec.seed, step)

    def update_read(self, state, delta, beta: float = 1.0, *,
                    scale: Optional[float] = None, rows=None, mask=None,
                    read_state=None, strict: bool = False, step=None):
        """The paper's linear-estimate EMA step:

            est_old = query(read_state or state, rows)
            d       = ema_delta(est_old, delta, beta, scale) * mask
            state   = update(state, rows, d)           (in place)
            est     = est_old + d       (strict: query(state) again)

        With ``backend`` set, and neither ``read_state`` nor ``strict``
        asking for the composed form, the step runs as one fused op,
        ``repro_torch.kernels.update_read``.  ``rows=None`` is the whole
        table, ``arange(n)``.  ``read_state`` lets the transforms' chunked
        loop read the pre-step sketch while adding into ``state``; it must
        not be ``state`` itself, which the update changes in place.
        ``step`` keys the rounding of bf16/int8 cells (both forms)."""
        if scale is None:
            scale = 1.0 - beta
        sr = self._sr_seed(step)
        if self.backend is not None and read_state is None and not strict:
            return kernels.update_read(self.spec, state, rows, delta,
                                       beta=beta, scale=scale, mask=mask,
                                       backend=self.backend, sr_seed=sr)
        ids = self._rows(rows, delta.device)
        src = state if read_state is None else read_state
        est_old = cs.query(self.spec, src, ids)
        d = cs.ema_delta(est_old, delta, beta, scale)
        if mask is not None:
            d = d * mask
        state = cs.update(self.spec, state, ids, d, sr_seed=sr)
        if strict:
            return state, cs.query(self.spec, state, ids)
        return state, est_old + d

    def bytes(self, state=None) -> int:
        return self.spec.nbytes()


@dataclasses.dataclass(frozen=True)
class CountSketchStore(_SketchStoreBase):
    """Signed Count-Sketch (median read): momentum, Adam's 1st moment."""
    kind = "sketch"
    _signed = True


@dataclasses.dataclass(frozen=True)
class CountMinStore(_SketchStoreBase):
    """Unsigned Count-Min (min read): Adagrad, Adam's 2nd moment.
    ``cleaning`` decays the state in place before each due step's reads."""
    cleaning: Optional[CleaningSchedule] = None

    kind = "countmin"
    _signed = False

    def clean(self, state, step):
        return maybe_clean(self.cleaning, state, step)


StoreResolver = Callable[[str, Tuple[int, ...]],
                         Optional[Tuple[Optional[Any], Optional[Any]]]]

_DENSE = DenseStore()


@dataclasses.dataclass(frozen=True)
class StoreTree:
    """path -> (m_store, v_store).  Resolution order: ``resolver`` >
    exact-path ``rules`` > defaults (``DenseStore``, as in the
    reference).  ``None`` in the m slot means no first moment (β₁=0); in
    the v slot, a rule without a second moment (momentum)."""

    rules: Tuple[Tuple[str, Optional[Any], Optional[Any]], ...] = ()
    default_m: Optional[Any] = _DENSE
    default_v: Optional[Any] = _DENSE
    resolver: Optional[StoreResolver] = None

    def resolve(self, path: str, shape, dtype=None):
        """The bound ``(m_store, v_store)`` pair for one parameter leaf."""
        pair = self.resolver(path, tuple(shape)) if self.resolver else None
        if pair is None:
            for p, m, v in self.rules:
                if p == path:
                    pair = (m, v)
                    break
        if pair is None:
            pair = (self.default_m, self.default_v)
        m, v = pair
        return (None if m is None else m.bind(path, shape, dtype),
                None if v is None else v.bind(path, shape, dtype))

    @classmethod
    def select(cls, *, m: Optional[Any] = _DENSE, v: Optional[Any] = _DENSE,
               where: Optional[Callable[[str, Tuple[int, ...]], bool]] = None,
               default_m: Optional[Any] = _DENSE,
               default_v: Optional[Any] = _DENSE) -> "StoreTree":
        """``where``-selected leaves (every leaf the stores accept, when
        ``where`` is None) get ``(m, v)``; the rest get the defaults."""
        def resolver(path, shape):
            if where is not None and not where(path, shape):
                return None
            if m is not None and not m.accepts(shape):
                return None
            if v is not None and not v.accepts(shape):
                return None
            return (m, v)
        return cls(default_m=default_m, default_v=default_v,
                   resolver=resolver)

    def with_backend(self, backend: Optional[str]) -> "StoreTree":
        """Every sketch-backed store (rules, defaults, resolver output)
        pinned to kernel ``backend``; specs, seeds and widths untouched,
        so states stay interchangeable."""
        def conv(s):
            if isinstance(s, _SketchStoreBase):
                return dataclasses.replace(s, backend=backend)
            return s

        rules = tuple((p, conv(m), conv(v)) for p, m, v in self.rules)
        out = dataclasses.replace(self, rules=rules,
                                  default_m=conv(self.default_m),
                                  default_v=conv(self.default_v))
        if self.resolver is None:
            return out
        base = self.resolver

        def resolver(path, shape):
            pair = base(path, shape)
            return None if pair is None else (conv(pair[0]), conv(pair[1]))

        return dataclasses.replace(out, resolver=resolver)

    def without_first_moment(self) -> "StoreTree":
        """The β₁=0 projection: every m slot forced to None (the layout of
        ``scale_by_rmsprop``)."""
        rules = tuple((p, None, v) for p, _m, v in self.rules)
        out = dataclasses.replace(self, rules=rules, default_m=None)
        if self.resolver is None:
            return out
        base = self.resolver

        def resolver(path, shape):
            pair = base(path, shape)
            return None if pair is None else (None, pair[1])

        return dataclasses.replace(out, resolver=resolver)


def tree_bytes(state) -> int:
    """Exact bytes of a state tree (nested dicts, lists and tuples): every
    tensor or array leaf counted as numel x itemsize, a ``QuantState``'s
    cells and scales both, the host int32 ``step`` as 4 B; ``None`` and
    Python scalars count 0."""
    if state is None:
        return 0
    if isinstance(state, dict):
        return sum(tree_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):        # QuantState included
        return sum(tree_bytes(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if hasattr(state, "shape") and hasattr(state, "dtype"):
        return int(getattr(state, "nbytes", 0))
    return 0
