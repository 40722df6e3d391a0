"""B3 · one moment's fused ``update_read`` over one sketch (the dense path).

Replaces the TPU kernel ``repro/kernels/cs_ema_tiled.py::cs_ema_tiled``:

    est_old = median (signed) or min of the item's depth cells
    d       = ema_delta(est_old, x, beta, scale) * mask
    S      += d scattered at the item's buckets (signed)
    est     = est_old + d

The TPU kernel streams across tiles of 8 rows: a tile reads the sketch
after the tiles before it wrote.  CUDA blocks run in no order, so the
CUDA kernel (``csrc/cs_ema_tiled.cu``) has the whole-batch semantics of
the reference's ``xla`` backend: every estimate reads the pre-step
sketch.  The two agree where no two rows share a bucket and differ by
estimator noise where they do, which on the dense path at full width is
always (about 15 rows a bucket).

Every column is independent, so the kernel runs in column slices of
``slice_cols`` columns, each done in full before the next, so that the
sketch slice and a scratch of one slice stay in the card's L2.  A slice
is two launches: a read launch writes ``est`` and ``d`` (into the (k, C)
scratch, reused by every slice), and a scatter launch adds ``sign*d``
into each sketch cell of the slice from a per-hash-row CSR of the items
sorted by bucket (``cs_update.bucket_csr``), in item order, starting
from the old cell.  That scatter is deterministic, uses no atomics and
adds in the CPU ``index_add_``'s order.  No padding: the mask carries
which rows take part.

bf16 cells (the TPU kernel's bf16 branch) run the same slices on a
``__nv_bfloat16`` sketch: the read launch widens the gathered cells to
f32, and the scatter launch visits EVERY cell of its slice, sums its
bucket's increments from zero in item order, adds the sum to the widened
cell and writes ``sr_bfloat16(cell + inc, cell_bits(seed, lin))`` with
``lin = (j·width + bucket)·dim + col`` and ``col`` the cell's column in
the whole sketch, not in its slice, the reference's
``_ema_update_read_lowp`` form (``repro/kernels/ops.py:259``), which
re-rounds the whole sketch.  The seed is ``quantize.step_seed`` of the
step, a uint32 launch argument.  Its launches are counted apart, on
``cs_ema_tiled_bf16``.

The ``ema_delta`` form is chosen on the host with the comparisons of
``core.sketch.ema_delta``, and ``scale`` and ``beta - 1`` are formed in
float64 there and rounded to float32 once, as JAX rounds its weakly
typed Python floats.  ``cs_ema_tiled_plain`` is the plain PyTorch version
(the reference's ``ema_update_read_xla`` on bucket/sign arrays); the
wrapper runs it only for CPU tensors, and for CUDA tensors launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core.sketch import ema_delta
from repro_torch.kernels import build, ref
from repro_torch.kernels.cs_update import bucket_csr, scatter_shapes

# ema_delta forms, in the order core.sketch.ema_delta tests them
ADAM, ADAGRAD, MOMENTUM = 0, 1, 2
# the launches of a slice, as ``parts`` of launch_slices
READ, SCATTER = 1, 2
# bytes of one slice's scratch and sketch columns: about half of the
# H100's 50 MB L2, so that they stay there beside the x and est stream
SLICE_BYTES = 24 << 20


def slice_cols(k: int, d: int, depth: int, width: int,
               cell_bytes: int) -> int:
    """Columns of one slice: the most whose f32 scratch (k rows) and
    sketch slice (depth x width cells of ``cell_bytes``) fit
    ``SLICE_BYTES``, a multiple of 32 (else of 4, at least 4); ``d``, one
    slice, when the whole call fits."""
    cols = SLICE_BYTES // max(1, 4 * k + cell_bytes * depth * width)
    if cols >= d:
        return d
    if cols >= 32:
        return cols - cols % 32
    return min(d, max(4, cols - cols % 4))


def ema_form(beta: float, scale: float) -> Tuple[int, bool]:
    """(form, unit_scale) of ``ema_delta(., ., beta, scale)``."""
    if scale == 1.0 - beta:
        return ADAM, scale == 1.0
    if beta == 1.0:
        return ADAGRAD, scale == 1.0
    return MOMENTUM, scale == 1.0


def _bf16(S: torch.Tensor, sr_seed) -> bool:
    if S.dtype != torch.bfloat16:
        return False
    if sr_seed is None:
        raise ValueError("bf16 cs_ema_tiled needs an sr_seed "
                         "(quantize.step_seed)")
    return True


def cs_ema_tiled_plain(S: torch.Tensor, b: torch.Tensor,
                       s: Optional[torch.Tensor], x: torch.Tensor,
                       mask: Optional[torch.Tensor], *, beta: float,
                       scale: float, sr_seed: Optional[int] = None,
                       scatter=ref.cs_update_ref
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B3 on any device; updates S in place.  A bf16
    ``S`` takes the reference's low-precision form: increments summed
    from zero in f32, added to the widened sketch, every cell re-rounded
    with ``sr_seed``.  ``scatter(S, b, s, d)`` adds the increments; the
    backends' plain routes pass ``cs_update``, which adds in the CPU's
    order on the card too."""
    est_old = ref.cs_query_ref(S, b, s)
    d = ema_delta(est_old, x, beta, scale)
    if mask is not None:
        d = d * mask
    if not _bf16(S, sr_seed):
        scatter(S, b, s, d)
        return S, est_old + d
    inc = scatter(torch.zeros(S.shape, dtype=torch.float32,
                              device=S.device), b, s, d)
    bits = qz.cell_bits(sr_seed, qz._lin_index(tuple(S.shape),
                                               device=S.device))
    S.copy_(qz.sr_bfloat16(S.to(torch.float32) + inc, bits))
    return S, est_old + d


def cs_ema_tiled(S: torch.Tensor, b: torch.Tensor, s: Optional[torch.Tensor],
                 x: torch.Tensor, mask: Optional[torch.Tensor], *,
                 beta: float, scale: float, csr=None,
                 sr_seed: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused EMA ``update_read`` over ``k`` rows of one sketch.

    S (depth, w, dim) f32 or bf16, updated IN PLACE; b (depth, k) int32
    buckets in range; s (depth, k) f32 signs or None (Count-Min); x (k,
    dim) f32; mask (k, 1) f32 or None; ``sr_seed`` the uint32 rounding
    seed, needed for bf16 cells.  ``csr`` is ``bucket_csr(b, w)`` when
    the caller has it (the dense path caches it).  Returns ``(S, est)``."""
    bf16 = _bf16(S, sr_seed)
    if S.device.type in ref.PLAIN_DEVICES:
        return cs_ema_tiled_plain(S, b, s, x, mask, beta=beta, scale=scale,
                                  sr_seed=sr_seed)
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"cs_ema_tiled: no kernel for device {dev}")
    depth, width, d, k = scatter_shapes("cs_ema_tiled", S, b, s, x)
    m = None if mask is None else mask.reshape(k)
    order, starts = csr if csr is not None else bucket_csr(b, width)
    build.check_cuda_inputs("cs_ema_tiled", dev,
                            cells=torch.bfloat16 if bf16 else torch.float32,
                            S=S, b=b, s=s, x=x, mask=m, order=order,
                            starts=starts)
    est = torch.empty((k, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((k, slice_cols(k, d, depth, width,
                                         S.element_size())),
                          dtype=torch.float32, device=dev)
    launch_slices(S, b, s, x, m, order, starts, est, scratch, beta=beta,
                  scale=scale, sr_seed=sr_seed)
    counter = cs_ema_tiled_bf16 if bf16 else cs_ema_tiled
    counter.launches += 1
    return S, est


def launch_slices(S, b, s, x, mask, order, starts, est, scratch, *,
                  beta: float, scale: float, sr_seed: Optional[int],
                  parts: int = READ | SCATTER) -> None:
    """Launch B3 on column slices as wide as ``scratch`` (k, C), with the
    launches ``parts`` names.  The inputs are checked by
    ``cs_ema_tiled``, which calls this and counts the call;
    ``chip_smoke.py`` times a call's reads and its scatters apart through
    it."""
    depth, width, d = S.shape
    k = x.shape[0]
    form, unit = ema_form(beta, scale)
    lib = build.library()
    args = (build.ptr(S), build.ptr(b), build.ptr(s), build.ptr(x),
            build.ptr(mask), build.ptr(order), build.ptr(starts),
            build.ptr(est), build.ptr(scratch), depth, width, d, k, form,
            int(unit), float(np.float32(scale)),
            float(np.float32(beta - 1.0)), scratch.shape[1], parts)
    with torch.cuda.device(S.device):
        if S.dtype == torch.bfloat16:
            rc = lib.cs_ema_tiled_bf16_launch(
                *args, int(sr_seed) & 0xFFFFFFFF,
                build.stream_handle(S.device))
        else:
            rc = lib.cs_ema_tiled_launch(*args,
                                         build.stream_handle(S.device))
    build.check_launch(rc, "cs_ema_tiled")


def cs_ema_tiled_bf16(S: torch.Tensor, *args, **kwargs):
    """``cs_ema_tiled`` on a bf16 sketch; its ``launches`` count B3's bf16
    launches, apart from the f32 ones."""
    if S.dtype != torch.bfloat16:
        raise ValueError(f"cs_ema_tiled_bf16: S is {S.dtype}, not bfloat16")
    return cs_ema_tiled(S, *args, **kwargs)


cs_ema_tiled.launches = 0
cs_ema_tiled_bf16.launches = 0
