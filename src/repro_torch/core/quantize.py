"""Low-precision sketch cells with stochastic rounding, in PyTorch.

Counterpart of ``repro.core.quantize``.  A sketch cell is stored as

  * ``float32``  - the plain ``(depth, width, dim)`` tensor;
  * ``bfloat16`` - a plain bf16 tensor, widened to f32 to be read;
  * ``int8``     - a ``QuantState``: int8 cells and one f32 scale per
    (hash row, block of ``scale_block`` buckets).

Every low-precision write rounds stochastically, so the sketched EMA
stays mean-unbiased:

  * int8: ``q = clip(floor(x/scale + u), -127, 127)``, ``u`` in [0, 1);
  * bf16: add 16 random low bits to the f32 bit pattern, then truncate
    the mantissa (exact when ``x`` is bf16-representable).

The random bits come from one uint32 seed per optimizer step
(``step_seed``: JAX's threefry-2x32 under the partitionable bit layout,
reimplemented in numpy on the host, so the reference and the port draw
the same seed) expanded per cell by a splitmix32 counter hash of the
cell's linear index (``cell_bits``).  Integers are uint32 values held in
int64 tensors and masked with ``& 0xFFFFFFFF``, as in ``hashing``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.hashing import _GOLDEN, _MASK, _mix

#: buckets sharing one f32 scale (int8 cells)
SCALE_BLOCK = 256

#: symmetric int8 range; -128 is never used
QMAX = 127.0

#: storage dtypes a sketch cell may take
CELL_DTYPES = ("float32", "bfloat16", "int8")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}
_INV_QMAX = float(np.float32(1.0 / QMAX))   # the reference's f32 reciprocal


class QuantState(NamedTuple):
    """int8 sketch state: ``cells`` (depth, width, dim) int8 and
    ``scales`` (depth, n_blocks) f32, the step of each block of
    ``scale_block`` buckets; a scale of 0 marks a never-written block."""

    cells: torch.Tensor
    scales: torch.Tensor


def is_quantized(state) -> bool:
    return isinstance(state, QuantState)


def cell_dtype_name(dtype) -> str:
    """Canonical name of a cell dtype ('float32' | 'bfloat16' | 'int8'),
    from a name, a ``torch.dtype`` or a numpy dtype; raises ValueError on
    any other dtype."""
    name = str(getattr(dtype, "name", dtype)).replace("torch.", "")
    if name not in CELL_DTYPES:
        raise ValueError(f"unsupported sketch cell dtype {name!r} "
                         f"(expected one of {CELL_DTYPES})")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` that holds cells of ``dtype``."""
    return _TORCH_DTYPES[cell_dtype_name(dtype)]


def n_blocks(width: int, scale_block: int = SCALE_BLOCK) -> int:
    return -(-int(width) // int(scale_block))


# ---------------------------------------------------------------------------
# Randomness: threefry per step, counter hash per cell
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) on numpy uint32 arrays, as
    ``jax._src.prng._threefry2x32_lowering`` unrolls it."""
    k1, k2, x0, x1 = (np.asarray(v, np.uint32).reshape(-1)
                      for v in (k1, k2, x0, x1))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def step_seed(seed: int, step=None) -> int:
    """uint32 stochastic-rounding seed of one optimizer step, the value
    of the reference's ``step_seed``: the threefry key of ``seed ^
    0x51AB5EED`` (``PRNGKey``), ``step`` folded in (``fold_in``; None
    keeps the step-0 stream), then 32 random bits at index 0 (the
    partitionable layout: the two output words XORed).  ``step`` is an
    int or a host tensor; nothing touches the device."""
    key = (np.uint32(0), np.uint32((int(seed) ^ 0x51AB5EED) & _MASK))
    if step is not None:
        key = threefry2x32(key[0], key[1], 0, int(step) & _MASK)
    hi, lo = threefry2x32(key[0], key[1], 0, 0)
    return int((hi ^ lo)[0])


def cell_bits(seed_u32: int, lin: torch.Tensor) -> torch.Tensor:
    """Per-cell uint32 rounding bits (in int64) from a step seed and the
    cells' linear indices: splitmix32 in counter mode."""
    x = (lin & _MASK) ^ (int(seed_u32) & _MASK)
    return _mix((_mix(x) + int(_GOLDEN)) & _MASK)


def _lin_index(shape, offset: int = 0, device="cpu") -> torch.Tensor:
    """Row-major linear cell indices of an array of ``shape``, shifted by
    ``offset``, as uint32 values in int64."""
    n = int(np.prod(shape))
    lin = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (lin + int(offset)) & _MASK


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from uint32 bits (the top 24, exact in f32)."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------

def sr_int8(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round pre-scaled values ``v = x / scale`` to int8:
    ``clip(floor(v + u), -127, 127)``."""
    q = torch.floor(v + _uniform(bits))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def sr_bfloat16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16: add ``bits & 0xFFFF`` to the f32 bit
    pattern (wrapping), clear the low 16 bits, then cast, which is exact
    since the value is now bf16-representable."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = ((u & _MASK) + (bits & 0xFFFF)) & 0xFFFF0000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Block scales
# ---------------------------------------------------------------------------

def block_scales(x: torch.Tensor, scale_block: int = SCALE_BLOCK
                 ) -> torch.Tensor:
    """Absmax scales of f32 sketch content ``x`` (depth, width, dim) ->
    (depth, n_blocks), times f32(1/127); all-zero blocks get 0."""
    d, w, dim = x.shape
    nb = n_blocks(w, scale_block)
    pad = nb * scale_block - w
    if pad:
        x = torch.cat([x, x.new_zeros((d, pad, dim))], dim=1)
    m = x.abs().reshape(d, nb, scale_block * dim).amax(dim=-1)
    return m * _INV_QMAX


def expand_scales(scales: torch.Tensor, width: int,
                  scale_block: int = SCALE_BLOCK) -> torch.Tensor:
    """(depth, n_blocks) -> (depth, width) per-bucket scales."""
    return scales.repeat_interleave(scale_block, dim=1)[:, :width]


def bucket_scales(scales: torch.Tensor, buckets: torch.Tensor,
                  scale_block: int = SCALE_BLOCK) -> torch.Tensor:
    """The scale of each bucket of a (depth, k) bucket array."""
    return torch.gather(scales, 1, buckets.long() // scale_block)


# ---------------------------------------------------------------------------
# Whole-sketch quantize / dequantize
# ---------------------------------------------------------------------------

def dequantize(state: QuantState, scale_block: int = SCALE_BLOCK
               ) -> torch.Tensor:
    """QuantState -> f32 (depth, width, dim)."""
    w = state.cells.shape[1]
    s = expand_scales(state.scales, w, scale_block)
    return state.cells.to(torch.float32) * s[:, :, None]


def quantize(x: torch.Tensor, seed_u32: int, *,
             scale_block: int = SCALE_BLOCK,
             scales: Optional[torch.Tensor] = None) -> QuantState:
    """f32 sketch content -> QuantState, stochastically rounded.  Fresh
    absmax scales when ``scales`` is None, else the given ones
    (saturating)."""
    w = x.shape[1]
    if scales is None:
        scales = block_scales(x, scale_block)
    s = expand_scales(scales, w, scale_block)[:, :, None]
    safe = torch.where(s > 0, s, torch.ones((), device=s.device))
    bits = cell_bits(seed_u32, _lin_index(tuple(x.shape), device=x.device))
    cells = sr_int8(x / safe, bits)
    cells = torch.where(s > 0, cells, torch.zeros((), dtype=torch.int8,
                                                  device=x.device))
    return QuantState(cells=cells, scales=scales)


def grown_scales(scales: torch.Tensor, x: torch.Tensor,
                 scale_block: int = SCALE_BLOCK) -> torch.Tensor:
    """The held scales enlarged, never shrunk, to fit content ``x``."""
    return torch.maximum(scales, block_scales(x, scale_block))
