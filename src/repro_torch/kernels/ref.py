"""Plain PyTorch forms of the sketch kernels, fed precomputed addressing.

Counterpart of ``repro.kernels.ref``.  Every function takes hash
``buckets``/``signs`` from ``repro_torch.core.hashing.HashFamily``, so a
kernel and its plain form see the same addressing.  Two semantics:

  * batch     — reads see the pre-step sketch; scatter-adds accumulate;
  * streaming — items one at a time, later items see earlier writes (the
                paper's per-item algorithm, Alg. 4).

``adam_fused_ref`` is the plain version of the streaming CUDA kernel
(``cs_adam.cs_adam_fused``) and updates ``M``/``V`` IN PLACE.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sketch import median_rows, min_rows

# the devices whose tensors take the plain versions: the CPU, and
# ``meta`` (shapes only, the dry run's device); a CUDA tensor launches
# its kernel or raises
PLAIN_DEVICES = ("cpu", "meta")


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by float32 division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which rounds differently from the kernels' and the reference's
    division; a divisor tensor on ``x``'s device keeps true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def cs_query_ref(S: torch.Tensor, buckets: torch.Tensor,
                 signs: Optional[torch.Tensor]) -> torch.Tensor:
    """Batch QUERY.  S (v,w,d) f32 or bf16 cells, read in f32; buckets
    (v,k); signs (v,k) or None for the Count-Min min-estimator.  Returns
    (k, d) f32."""
    b = buckets.long()
    rows = [S[j].index_select(0, b[j]).to(torch.float32)
            for j in range(S.shape[0])]
    if signs is None:
        return min_rows(rows)
    return median_rows([r * signs[j][:, None].to(torch.float32)
                        for j, r in enumerate(rows)])


def cs_update_ref(S: torch.Tensor, buckets: torch.Tensor,
                  signs: Optional[torch.Tensor],
                  delta: torch.Tensor) -> torch.Tensor:
    """Batch UPDATE (scatter-add of delta (k, d)), IN PLACE.  Returns S."""
    b = buckets.long()
    delta = delta.to(S.dtype)
    for j in range(S.shape[0]):
        u = delta if signs is None else signs[j][:, None].to(S.dtype) * delta
        S[j].index_add_(0, b[j], u)
    return S


def cs_update_slab_ref(S: torch.Tensor, local: torch.Tensor,
                       signs: Optional[torch.Tensor],
                       delta: torch.Tensor) -> torch.Tensor:
    """Slab UPDATE, IN PLACE: ``cs_update_ref`` of the items whose local
    bucket lies in the slab, ``[0, S.shape[1])``; bucket ``S.shape[1]``
    (another shard's) is dropped.  Returns S."""
    lw = S.shape[1]
    delta = delta.to(S.dtype)
    for j in range(S.shape[0]):
        keep = local[j] < lw
        u = delta if signs is None else signs[j][:, None].to(S.dtype) * delta
        S[j].index_add_(0, local[j][keep].long(), u[keep])
    return S


def adam_fused_ref(M: Optional[torch.Tensor], V: torch.Tensor,
                   bm: Optional[torch.Tensor], sm: Optional[torch.Tensor],
                   bv: torch.Tensor, g: torch.Tensor, *,
                   lr: float, b1: float, b2: float, eps: float,
                   bc1: float, bc2: float
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Streaming CS-Adam (paper Alg. 4), one item at a time in order.

    M: signed sketch of the 1st moment, or None for β₁=0; V: count-min
    sketch of the 2nd moment; bm/sm: (v,k) buckets and signs for M; bv:
    (v,k) buckets for V; g: (k, d) rows.  The scalars are Python floats
    that multiply as float32.  Returns (M', V', updates (k, d)) with M, V
    updated in place."""
    depth = V.shape[0]
    k = g.shape[0]
    upd = torch.empty((k, g.shape[1]), dtype=torch.float32, device=g.device)
    j_idx = torch.arange(depth, device=V.device)
    bv = bv.long()
    if M is not None:
        bm = bm.long()
        sm = sm.to(torch.float32)
    for i in range(k):
        g_i = g[i]
        if M is not None:
            raw = M[j_idx, bm[:, i]]                        # (v, d)
            s_i = sm[:, i][:, None]
            m_old = median_rows(list(raw * s_i))
            dm = (1.0 - b1) * (g_i - m_old)
            M[j_idx, bm[:, i]] = raw + s_i * dm[None]
            mhat = true_div(m_old + dm, bc1)
        else:
            mhat = g_i
        raw_v = V[j_idx, bv[:, i]]
        v_old = min_rows(list(raw_v))
        dv = (1.0 - b2) * (g_i * g_i - v_old)
        V[j_idx, bv[:, i]] = raw_v + dv[None]
        v_new = torch.clamp_min(v_old + dv, 0.0)
        vhat = true_div(v_new, bc2)
        upd[i] = -lr * mhat / (torch.sqrt(vhat) + eps)
    return M, V, upd
