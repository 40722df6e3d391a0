"""AuxStore codecs and the StoreTree resolver, f32 cells.

Counterpart of ``repro.core.stores``.  A store is how one optimizer moment
is kept; the protocol is

    store.init(device)              -> state            (zeroed)
    store.accumulate(state, delta, rows=None, scale=1.0)
    store.decay(state, beta)
    store.read(state, rows=None)    -> values           (estimate rows)
    store.update_read(state, delta, beta, ...) -> (state, est)
    store.clean(state, step)        -> state            (cleaning hook)
    store.stats(state)              -> {name: device scalar} (health gauges)

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
  * ``Rank1Store``       - the non-negative rank-1 (row x col) 2nd moment
    of the LR-NMF-V baseline, a ``Rank1Moment``;
  * ``StoreTree``        - path -> (m_store, v_store).

Stores are frozen dataclasses that double as factories: ``bind(path,
shape, dtype)`` sizes one leaf's state with the same per-leaf seed
(``leaf_seed``) as the reference, so both packages address the same
buckets.  A sketch store's ``dtype`` names its cells ('float32' |
'bfloat16' | 'int8'); an int8 state is a ``quantize.QuantState``.  Every
state is updated IN PLACE and returned.  A rule-based ``StoreTree``
serialises to the reference's JSON (``to_json``/``from_json``, the form
plans and checkpoint manifests carry).  ``stats`` gives the telemetry's
health gauges as device scalars, with no host sync, over the
reference's strided sample of at most ``STATS_SAMPLE_CELLS`` cells.
``tree_bytes`` counts a state tree's bytes.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import quantize as qz
from repro_torch.core import sketch as cs
from repro_torch.core.cleaning import CleaningSchedule, maybe_clean
from repro_torch.core.sketch import SketchSpec


class Rank1Moment(NamedTuple):
    """Non-negative rank-1 factors of a 2nd-moment leaf (LR-NMF-V):
    ``V[i, j] = r[i]·c[j] / mean(r)``."""
    r: torch.Tensor  # (n,) EMA of row means
    c: torch.Tensor  # (d,) EMA of column means


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

    def stats(self, state) -> Dict[str, Any]:
        """Health gauges for ``obs.probes.TableMonitor``: a dict of device
        scalars computed without a host sync, fetched only at log
        boundaries.  Base: empty."""
        return {}


# Stats reductions scan at most this many cells (the reference's cap):
# above it the gauges read a deterministic strided sample, so a
# log-boundary collect stays cheap however large the state.
STATS_SAMPLE_CELLS = 8192


def _nonzero_fraction(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The f32 fraction of nonzero entries (along ``dim``): the exact
    count times the f32 reciprocal of the length, which is how XLA lowers
    the reference's ``jnp.mean`` (a correctly rounded division can differ
    in the last bit)."""
    nz = (x != 0.0).to(torch.float32)
    n = x.numel() if dim is None else x.shape[dim]
    inv = torch.full((), np.float32(1.0) / np.float32(n),
                     dtype=torch.float32, device=x.device)
    return (nz.sum() if dim is None else nz.sum(dim=dim)) * inv


def _strided_sample(flat: torch.Tensor):
    """``(flat[::stride] as f32, stride)``, the stride
    ``max(size // STATS_SAMPLE_CELLS, 1)``."""
    stride = max(int(flat.numel()) // STATS_SAMPLE_CELLS, 1)
    return flat[::stride].to(torch.float32), stride


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

    def stats(self, state) -> Dict[str, Any]:
        # the sketches' sampling: a dense (n, d) buffer can dwarf them
        f, stride = _strided_sample(state.reshape(-1))
        return {"occupancy": _nonzero_fraction(f),
                "mass": f.abs().sum() * stride}


@dataclasses.dataclass(frozen=True)
class Rank1Store(AuxStore):
    """The rank-1 (row x col) 2nd moment of the LR-NMF-V baseline: a
    ``Rank1Moment`` of f32 factors.  ``read`` reconstructs ``r⊗c /
    (mean(r) + eps)`` (at ``rows`` when given); ``accumulate`` adds
    ``scale·mean(delta)`` along each axis, so ``decay(β₂)`` then
    ``accumulate`` is ``lowrank.nmf_rank1_adam``'s EMA."""

    eps: float = 1e-30
    shape: Optional[Tuple[int, int]] = None     # set by bind()

    kind = "rank1"

    def accepts(self, shape) -> bool:
        return len(shape) == 2

    def bind(self, path, shape, dtype=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError(f"Rank1Store needs a rank-2 (rows, dim) leaf, "
                             f"got {shape} at {path!r}")
        return dataclasses.replace(self, shape=shape)

    def init(self, device="cuda") -> Rank1Moment:
        n, d = self.shape
        return Rank1Moment(torch.zeros((n,), dtype=torch.float32,
                                       device=device),
                           torch.zeros((d,), dtype=torch.float32,
                                       device=device))

    def accumulate(self, state, delta, rows=None, *, scale: float = 1.0):
        if rows is not None:
            raise ValueError("Rank1Store.accumulate takes full (n, d) "
                             "deltas (rows=None)")
        state.r.add_(scale * delta.mean(dim=1))
        state.c.add_(scale * delta.mean(dim=0))
        return state

    def decay(self, state, beta):
        state.r.mul_(beta)
        state.c.mul_(beta)
        return state

    def read(self, state, rows=None):
        r = state.r if rows is None else state.r[rows.long()]
        return (r[:, None] * state.c[None, :]) / (state.r.mean() + self.eps)

    def bytes(self, state=None) -> int:
        if state is not None:
            return tree_bytes(state)
        n, d = self.shape
        return (n + d) * 4

    def stats(self, state) -> Dict[str, Any]:
        return {"occupancy": _nonzero_fraction(state.r),
                "mass": state.r.abs().sum() + state.c.abs().sum(),
                "r_norm": torch.linalg.vector_norm(state.r),
                "c_norm": torch.linalg.vector_norm(state.c)}


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

    def with_sharding(self, shards: int,
                      layout: str = "width") -> "_SketchStoreBase":
        """The same store laid out over ``shards`` slabs under ``layout``:
        the factory fields and (when bound) the spec.  ``init`` still
        makes the full (depth, width, dim) state; the sharded step
        (``sparse_rows_adam_sharded``) runs on one shard's slab of it
        (``distributed.slabs.shard_state``), and the dense path runs the
        full tensor on one device."""
        out = dataclasses.replace(self, shards=int(shards),
                                  shard_layout=layout)
        if self.spec is not None:
            out = dataclasses.replace(out, spec=dataclasses.replace(
                self.spec, shards=int(shards), layout=layout))
        return out

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

    def shard_bytes(self, state=None) -> int:
        """Bytes of one width slab: what a device holds of this store when
        it is sharded."""
        return self.spec.shard_nbytes()

    def stats(self, state) -> Dict[str, Any]:
        """Sketch-health gauges, all device scalars:

          * ``occupancy``   - fraction of nonzero cells (saturation);
          * ``mass``        - total absolute cell mass, sum |S|;
          * ``max_cell``    - the heaviest single cell;
          * ``sign_cancel`` - ``1 - |sum S| / sum |S|``, the share of
            absolute mass lost to sign cancellation.

        Above ``STATS_SAMPLE_CELLS`` cells they read a deterministic
        strided sample (the reference's cells): fractions are sampled,
        ``mass`` is scaled back up by the stride, ``max_cell`` is the
        sampled max.  int8 cells (``QuantState``) dequantize only the
        sampled cells and add ``quant_scale_max``, the largest block
        scale.  A sharded spec adds per-slab occupancy extremes
        (``shard_occ_min``/``shard_occ_max``)."""
        spec = self.spec
        out: Dict[str, Any] = {}
        if isinstance(state, qz.QuantState):
            cells = state.cells.reshape(-1)
            stride = max(int(cells.numel()) // STATS_SAMPLE_CELLS, 1)
            idx = torch.arange(0, int(cells.numel()), stride,
                               device=cells.device)
            col = (idx // spec.dim) % spec.width
            row = idx // (spec.dim * spec.width)
            sc = state.scales[row, col // spec.scale_block]
            f = cells[idx].to(torch.float32) * sc
            out["quant_scale_max"] = state.scales.max()
        else:
            f, stride = _strided_sample(state.reshape(-1))
        absmass = f.abs().sum()
        out.update({
            "occupancy": _nonzero_fraction(f),
            "mass": absmass * stride,
            "max_cell": f.abs().max(),
            "sign_cancel": 1.0 - f.sum().abs() / (absmass + 1e-30),
        })
        if spec.shards > 1:
            # slab s of hash row j holds buckets [s*lw, (s+1)*lw): sample
            # each slab's (depth, lw, dim) cells with the reference's
            # stride, gathered in place rather than through a moved copy
            lw = spec.width // spec.shards
            per = spec.depth * lw * spec.dim
            sstride = max(per // max(STATS_SAMPLE_CELLS // spec.shards, 1),
                          1)
            dev = state.device
            j = torch.arange(0, per, sstride, device=dev)
            dep, rem = j // (lw * spec.dim), j % (lw * spec.dim)
            shard = torch.arange(spec.shards, device=dev)[:, None]
            flat_idx = dep[None] * (spec.width * spec.dim) \
                + shard * (lw * spec.dim) + rem[None]
            occ = _nonzero_fraction(state.reshape(-1)[flat_idx], dim=1)
            out["shard_occ_min"] = occ.min()
            out["shard_occ_max"] = occ.max()
        return out


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

    def stats(self, state, clean_pending: bool = False) -> Dict[str, Any]:
        """Adds ``clean_next_removes``, the mass the next clean removes,
        ``(1 - alpha) * mass``; 0 when ``clean_pending`` (an async decay
        already dispatched: quoting it again would count it twice)."""
        out = super().stats(state)
        if self.cleaning is not None:
            if clean_pending:
                out["clean_next_removes"] = torch.zeros_like(out["mass"])
            else:
                out["clean_next_removes"] = ((1.0 - self.cleaning.alpha)
                                             * out["mass"])
        return out

    def cleans_between(self, start_step: int, end_step: int) -> int:
        """How many cleanings fire on steps in ``(start, end]``: host-side
        schedule arithmetic for the log-interval telemetry."""
        if self.cleaning is None or end_step <= start_step:
            return 0
        every = self.cleaning.every
        return max(end_step // every - max(start_step, 0) // every, 0)


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

    def sketch_specs(self, params_like) -> Dict[str, Dict[str, SketchSpec]]:
        """{path: {"m": spec?, "v": spec?}} for every leaf of
        ``params_like`` (tensors or shaped leaves) that resolves to a
        sketch-backed store."""
        from repro_torch.core.partition import leaf_paths
        out: Dict[str, Dict[str, SketchSpec]] = {}
        for path, leaf in leaf_paths(params_like):
            m, v = self.resolve(path, tuple(leaf.shape),
                                getattr(leaf, "dtype", None))
            d = {}
            if m is not None and m.kind in ("sketch", "countmin"):
                d["m"] = m.spec
            if v is not None and v.kind in ("sketch", "countmin"):
                d["v"] = v.spec
            if d:
                out[path] = d
        return out

    def sketch_state_shapes(self, param_shapes: Dict[str, Tuple[int, ...]]
                            ) -> Dict[Tuple[str, str], Tuple[int, int, int]]:
        """{(slot, path): (depth, width, dim)} for every parameter whose
        ``m``/``v`` slot resolves to a sketch-backed store (the
        error-feedback ``residual`` shares the 'v' geometry)."""
        return {k: tuple(spec.shape)
                for k, spec in self.sketch_state_specs(param_shapes).items()}

    def sketch_state_specs(self, param_shapes: Dict[str, Tuple[int, ...]]
                           ) -> Dict[Tuple[str, str], SketchSpec]:
        """{(slot, path): bound SketchSpec}, the richer form of
        ``sketch_state_shapes``: the spec carries ``shards``/``layout``.
        A leaf its stores reject is left out."""
        out: Dict[Tuple[str, str], SketchSpec] = {}
        for path, shape in param_shapes.items():
            try:
                m, v = self.resolve(path, shape, torch.float32)
            except Exception:   # noqa: BLE001 - stores rejecting the leaf
                continue
            for slot, st in (("m", m), ("v", v)):
                if st is not None and st.kind in ("sketch", "countmin") \
                        and getattr(st, "spec", None) is not None:
                    out[(slot, path)] = st.spec
        return out

    def to_json(self) -> Dict[str, Any]:
        """The reference's JSON form (rule-based trees only)."""
        if self.resolver is not None:
            raise ValueError("only rule-based StoreTrees serialize; "
                             "resolver-based trees (policy bridges) are "
                             "programmatic-only")
        return {
            "version": 1,
            "default_m": store_to_json(self.default_m),
            "default_v": store_to_json(self.default_v),
            "rules": [{"path": p, "m": store_to_json(m),
                       "v": store_to_json(v)} for p, m, v in self.rules],
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StoreTree":
        if d.get("version") != 1:
            raise ValueError(f"unknown StoreTree version {d.get('version')!r}")
        return cls(
            rules=tuple((e["path"], store_from_json(e["m"]),
                         store_from_json(e["v"])) for e in d["rules"]),
            default_m=store_from_json(d["default_m"]),
            default_v=store_from_json(d["default_v"]))


# ---------------------------------------------------------------------------
# JSON codecs: the reference's dicts key for key
# ---------------------------------------------------------------------------

def spec_to_json(spec: SketchSpec) -> Dict[str, Any]:
    """Sharding keys only when not the defaults, ``scale_block`` only when
    not ``SCALE_BLOCK``: unsharded f32 specs serialise as they always
    did."""
    out = {"depth": spec.depth, "width": spec.width, "dim": spec.dim,
           "signed": bool(spec.signed), "seed": int(spec.seed),
           "dtype": spec.cell_dtype_name,
           "identity": bool(spec.identity)}
    if spec.shards != 1 or spec.layout != "width":
        out["shards"] = int(spec.shards)
        out["layout"] = spec.layout
    if spec.scale_block != qz.SCALE_BLOCK:
        out["scale_block"] = int(spec.scale_block)
    return out


def spec_from_json(d: Dict[str, Any]) -> SketchSpec:
    return SketchSpec(depth=int(d["depth"]), width=int(d["width"]),
                      dim=int(d["dim"]), signed=bool(d["signed"]),
                      seed=int(d["seed"]),
                      dtype=qz.cell_dtype_name(d["dtype"]),
                      identity=bool(d["identity"]),
                      shards=int(d.get("shards", 1)),
                      layout=d.get("layout", "width"),
                      scale_block=int(d.get("scale_block", qz.SCALE_BLOCK)))


def store_to_json(store) -> Optional[Dict[str, Any]]:
    if store is None:
        return None
    out: Dict[str, Any] = {"kind": store.kind}
    if isinstance(store, DenseStore):
        if store.dtype is not None:
            out["dtype"] = store.dtype
        if store.shape is not None:
            out["shape"] = list(store.shape)
        return out
    if isinstance(store, _SketchStoreBase):
        if store.spec is not None:
            out["spec"] = spec_to_json(store.spec)
        else:
            out.update(compression=store.compression, depth=store.depth,
                       width=store.width, width_multiple=store.width_multiple,
                       seed=store.seed, dtype=store.dtype,
                       identity=store.identity)
        if store.shape is not None:
            out["shape"] = list(store.shape)
        if store.backend is not None:
            out["backend"] = store.backend
        if store.shards != 1 or store.shard_layout != "width":
            out["shards"] = int(store.shards)
            out["shard_layout"] = store.shard_layout
        if isinstance(store, CountMinStore) and store.cleaning is not None:
            out["cleaning"] = {"alpha": store.cleaning.alpha,
                               "every": store.cleaning.every}
            if store.cleaning.mode != "sync":
                out["cleaning"]["mode"] = store.cleaning.mode
        return out
    if isinstance(store, Rank1Store):
        if store.shape is not None:
            out["shape"] = list(store.shape)
        return out
    raise TypeError(f"cannot serialize store {store!r}")


def store_from_json(d: Optional[Dict[str, Any]]):
    if d is None:
        return None
    kind = d["kind"]
    shape = tuple(int(s) for s in d["shape"]) if d.get("shape") else None
    if kind == "dense":
        return DenseStore(dtype=d.get("dtype"), shape=shape)
    if kind in ("sketch", "countmin"):
        cls = CountSketchStore if kind == "sketch" else CountMinStore
        kw: Dict[str, Any] = {"shape": shape, "backend": d.get("backend"),
                              "shards": int(d.get("shards", 1)),
                              "shard_layout": d.get("shard_layout", "width")}
        if "spec" in d:
            kw["spec"] = spec_from_json(d["spec"])
        else:
            kw.update(compression=float(d["compression"]),
                      depth=int(d["depth"]),
                      width=None if d["width"] is None else int(d["width"]),
                      width_multiple=int(d["width_multiple"]),
                      seed=int(d["seed"]), dtype=d["dtype"],
                      identity=bool(d["identity"]))
        if kind == "countmin" and d.get("cleaning") is not None:
            kw["cleaning"] = CleaningSchedule(
                alpha=float(d["cleaning"]["alpha"]),
                every=int(d["cleaning"]["every"]),
                mode=d["cleaning"].get("mode", "sync"))
        return cls(**kw)
    if kind == "rank1":
        return Rank1Store(shape=shape)
    raise ValueError(f"unknown store kind {kind!r}")


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
