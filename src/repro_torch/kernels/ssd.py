"""B14 · the Mamba2 SSD's chunked scan on bf16 x, B, C: forward and
backward kernels, and the plain math in their layouts.

Replaces no TPU kernel: the reference's SSD is XLA einsums
(``repro/models/mamba.py::ssd_chunked``), which the port's plain form
(``models/mamba.py::ssd_chunked``) repeats as f32 passes over
(b, chunks, heads, L, L) tensors.  The CUDA kernels (``csrc/ssd.cuh``,
entry points ``csrc/ssd.cu``) follow the SSD paper's decomposition by
stages, each a function here:

* forward: the in-chunk cumsum of the log-decays (``Acs``, (b, c, h, L)),
  each chunk's own state term, the pass over the chunks (``states``, the
  state before each chunk, (b, c, h, p, n) f32), and the chunk scan
  ``y = round_bf16(M)·x + exp(Acs)·C·h_before`` with M's tiles formed
  in registers and never stored;
* backward: the chunks' pull on the state before them, the reverse pass
  over the chunks, C·Bᵀ's gradient summed over the heads, each head's
  in-chunk terms (dx, ddt and the log-decays'), dB and dC summed over
  the heads, and the reverse cumsum that gives dla.

``ssd_fwd_plain`` is the plain form, which ``ssd_chunked`` runs on every
input the kernels do not take; ``ssd_bwd_plain`` is the
backward by the kernels' stages in f32, which keeps f32 where autograd
rounds to bf16 on the plain form (the backward of the casts of M and of
w·x), as the kernels do.  The wrappers take CUDA tensors only
(``models.mamba.ssd_chunked`` routes every other input to the plain form)
and raise on what the kernels do not take.  Each counts its calls in
``launches`` and reports the FLOPs of the plain form's products to a
running ``OpCost`` (``obs.profiling.kernel_work``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.obs.profiling import kernel_work

HEAD_DIM = 64
# the (chunk, state) pairs the kernels are built for: zamba2-2.7b's and
# granite-4.0-h-small's
PAIRS = ((64, 64), (256, 128))
HEAD_GROUP = 16         # heads whose C·Bᵀ gradients one block sums
PASS_ELEMS = 1024       # state elements a block of a pass kernel takes

F32, BF16 = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the plain math in the kernels' layouts
# ---------------------------------------------------------------------------

def ssd_fwd_plain(x, dt, la, B, C, h0, chunk: int,
                  Acs: Optional[torch.Tensor] = None):
    """The plain form of the chunked SSD, which ``models.mamba.ssd_chunked``
    runs on every input the kernels do not take (``chunk`` dividing the
    length), with the roundings and masked exponents that
    ``models.mamba``'s docstring describes.  Returns (y (b, s, h, p) f32,
    h_final, states (b, c, h, p, n) f32: the state before each chunk, Acs
    (b, c, h, L): the in-chunk cumsum of la).  A given ``Acs`` takes the
    cumsum's place, so that the kernels' forward can be held to the plain
    form apart from the order of the cumsum's f32 sums: w and M round to
    bf16, where a last-bit difference of Acs can land on another bf16."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L, nc = chunk, s // chunk
    f32 = torch.float32
    xb = x.reshape(b, nc, L, h, p)
    Bb = B.reshape(b, nc, L, n)
    Cb = C.reshape(b, nc, L, n)
    # heads ahead of the chunk's positions: (b, c, h, L) and the (L, L)
    # matrices last, so the masks are ``tril`` and the products batched
    # matmuls without a transposed copy
    dtT = dt.reshape(b, nc, L, h).transpose(2, 3)
    laI = torch.cumsum(la.reshape(b, nc, L, h).to(f32).transpose(2, 3),
                       dim=3) if Acs is None else Acs          # (b,c,h,L)
    # intra-chunk: M[i, j] = exp(laI_i − laI_j)·(C_i·B_j)·dt_j, j ≤ i.
    # Above the diagonal the exponents are positive and may overflow:
    # they are zeroed before the exp (see models.mamba's docstring)
    dec = (laI[..., :, None] - laI[..., None, :]).tril()       # (b,c,h,i,j)
    cb = torch.einsum("bcin,bcjn->bcij", Cb.to(f32), Bb.to(f32))
    M = (torch.exp(dec) * (cb[:, :, None] * dtT[..., None, :])).tril()
    # M rounded to x's dtype, then exact products summed in f32
    xT = xb.transpose(2, 3).to(f32)                             # (b,c,h,L,p)
    y = M.to(x.dtype).to(f32) @ xT                              # (b,c,h,i,p)
    # the state update's terms: w rounded to x's dtype, w·x in x's dtype
    la_tot = laI[..., -1:]                                      # (b,c,h,1)
    w = torch.exp(la_tot - laI) * dtT                           # f32
    wx = (w.to(x.dtype)[..., None] * xb.transpose(2, 3)).to(f32)
    upd = wx.transpose(3, 4) @ Bb.to(f32)[:, :, None]          # (b,c,h,p,n)
    decay = torch.exp(la_tot)[..., None]                        # (b,c,h,1,1)
    hs, before = h0, []
    for c in range(nc):
        before.append(hs)
        hs = decay[:, c] * hs + upd[:, c]
    # inter-chunk: y_i += exp(laI_i)·C_i·h (the state before the chunk)
    states = torch.stack(before, dim=1)                         # (b,c,h,p,n)
    y = y + torch.exp(laI)[..., None] * (
        Cb.to(f32)[:, :, None] @ states.transpose(3, 4))
    y = y.transpose(2, 3)                                       # (b,c,L,h,p)
    return y.reshape(b, s, h, p), hs, states, laI.contiguous()


def ssd_bwd_plain(x, dt, B, C, states, Acs, dy, dhT=None):
    """The backward of ``ssd_fwd_plain`` by the kernels' stages, in f32:
    x, B, C as the forward took them, ``states`` and ``Acs`` as it
    returned them, dy (b, s, h, p), dhT the gradient of h_final or None.
    Returns (dx, ddt, dla, dB, dC, dh0), all f32."""
    b, s, h, p = x.shape
    nc, L = Acs.shape[1], Acs.shape[3]
    n = B.shape[-1]
    xT = x.reshape(b, nc, L, h, p).transpose(2, 3)               # (b,c,h,L,p)
    xf = xT.to(F32)
    dyb = dy.reshape(b, nc, L, h, p).transpose(2, 3).to(F32)
    Bf = B.reshape(b, nc, L, n).to(F32)
    Cf = C.reshape(b, nc, L, n).to(F32)
    dtT = dt.reshape(b, nc, L, h).transpose(2, 3)                # (b,c,h,L)
    A, T = Acs, Acs[..., -1:]
    G = torch.exp(A)
    # the chunks' pull on the state before them (V), and the log-decays'
    # gradient through the inter-chunk term
    Gdy = G[..., None] * dyb
    V = Gdy.transpose(3, 4) @ Cf[:, :, None]                     # (b,c,h,p,n)
    Q = Cf[:, :, None] @ states.transpose(3, 4)                  # (b,c,h,L,p)
    dA = G * torch.sum(dyb * Q, dim=-1)
    # the reverse pass: dU, the gradient of each chunk's state term
    g = torch.zeros_like(states[:, 0]) if dhT is None else dhT.to(F32)
    dU, dTs = torch.empty_like(states), []
    for c in reversed(range(nc)):
        dU[:, c] = g
        dTs.append(torch.sum(g * states[:, c], dim=(-2, -1)))
        g = torch.exp(T[:, c])[..., None] * g + V[:, c]
    dTs = torch.exp(T[..., 0]) * torch.stack(dTs[::-1], dim=1)    # (b,c,h)
    # each head's in-chunk terms
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    E = torch.exp((A[..., :, None] - A[..., None, :]).tril())
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[:, :, None]
    X = cb * dtT[..., None, :]
    Mr = torch.where(mask, E * X, 0.0).to(x.dtype).to(F32)
    dM = torch.where(mask, dyb @ xf.transpose(3, 4), 0.0)
    ddec = (dM * X) * E
    dA = dA + torch.sum(ddec, dim=-1) - torch.sum(ddec, dim=-2)
    ddt = torch.sum((dM * E) * cb, dim=-2)
    dCB = torch.sum((dM * E) * dtT[..., None, :], dim=2)         # (b,c,i,j)
    e = torch.exp(T - A)
    wr = (e * dtT).to(x.dtype)
    wx = (wr[..., None] * xT).to(F32)
    dwx = Bf[:, :, None] @ dU.transpose(3, 4)                    # (b,c,h,L,p)
    dx = Mr.transpose(3, 4) @ dyb + dwx * wr.to(F32)[..., None]
    dw = torch.sum(dwx * xf, dim=-1)
    ddt = ddt + dw * e
    dd = (dw * dtT) * e
    dA = dA - dd
    dA[..., -1] += torch.sum(dd, dim=-1) + dTs
    # the log-decays' gradient: the reverse cumsum over the chunk
    dla = torch.flip(torch.cumsum(torch.flip(dA, (3,)), dim=3), (3,))
    # dB and dC, summed over the heads
    dC = dCB @ Bf + torch.sum(Gdy @ states, dim=2)
    dB = dCB.transpose(2, 3) @ Cf + torch.sum(wx @ dU, dim=2)

    def rows(t):                                     # (b,c,h,L,·) -> (b,s,h,·)
        return t.transpose(2, 3).reshape((b, s, h) + t.shape[4:])
    return (rows(dx), rows(ddt[..., None])[..., 0],
            rows(dla[..., None])[..., 0], dB.reshape(b, s, n),
            dC.reshape(b, s, n), g)


def plain_flops(x: torch.Tensor, B: torch.Tensor, chunk: int,
                backward: bool) -> float:
    """The FLOPs of the plain form's products, as ``OpCost`` counts them:
    C·Bᵀ, M·x, the chunk states' (w·x)ᵀ·B and C·h, every (L, L) matrix
    whole; a backward takes two products for each."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    fwd = 2 * b * s * chunk * n + 2 * b * h * s * (chunk * p + 2 * p * n)
    return float((2 if backward else 1) * fwd)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name: str, chunk: int, **tensors) -> None:
    dev = tensors["x"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    check_shapes(name, chunk, **tensors)


def check_shapes(name: str, chunk: int, **tensors) -> None:
    """Raise unless the given tensors (None skipped) have the shapes,
    dtypes, device, contiguity and alignment the kernels take, x's
    device being the one."""
    x = tensors["x"]
    dev = x.device
    if x.dim() != 4 or x.shape[3] != HEAD_DIM:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (b, s, h, "
                         f"{HEAD_DIM})")
    b, s, h, p = x.shape
    n = tensors["B"].shape[-1]
    if (chunk, n) not in PAIRS or s % chunk:
        raise ValueError(f"{name}: chunk {chunk} and state {n} (pairs "
                         f"{PAIRS}) or length {s} not taken")
    nc = s // chunk
    want = dict(x=((b, s, h, p), BF16), dt=((b, s, h), F32),
                la=((b, s, h), F32), B=((b, s, n), BF16),
                C=((b, s, n), BF16), h0=((b, h, p, n), F32),
                dy=((b, s, h, p), F32), dhT=((b, h, p, n), F32),
                states=((b, nc, h, p, n), F32), Acs=((b, nc, h, chunk), F32))
    for key, t in tensors.items():
        if t is None:
            continue
        shape, dtype = want[key]
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, la: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, ...]:
    """x (b, s, h, 64) bf16; dt, la (b, s, h) f32; B, C (b, s, n) bf16;
    h0 (b, h, 64, n) f32; (chunk, n) one of ``PAIRS``, chunk dividing s.
    Returns ``ssd_fwd_plain``'s (y, h_final, states, Acs)."""
    _check("ssd_fwd", chunk, x=x, dt=dt, la=la, B=B, C=C, h0=h0)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=F32, device=dev)
    hT = torch.empty_like(h0)
    states = torch.empty((b, s // chunk, h, p, n), dtype=F32, device=dev)
    Acs = torch.empty((b, s // chunk, h, chunk), dtype=F32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.ssd_fwd_launch(
            *map(build.ptr, (x, dt, la, B, C, h0, y, hT, states, Acs)),
            b, s, h, chunk, n, build.stream_handle(dev))
    build.check_launch(rc, "ssd_fwd")
    ssd_fwd.launches += 1
    kernel_work("ssd_fwd", plain_flops(x, B, chunk, False),
                (x, dt, la, B, C, h0, y, hT, states, Acs))
    return y, hT, states, Acs


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, states: torch.Tensor, Acs: torch.Tensor,
            dy: torch.Tensor, dhT: Optional[torch.Tensor],
            needs: Sequence[bool] = (True,) * 6
            ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of ``ssd_fwd`` for dy (y's shape, f32) and dhT
    (h_final's, or None for none).  Returns (dx, ddt, dla, dB, dC, dh0):
    dx, dB, dC bf16 (their f32 sums rounded once), the rest f32; None
    where ``needs`` (x, dt, la, B, C, h0) is false."""
    chunk = Acs.shape[-1]
    _check("ssd_bwd", chunk, x=x, dt=dt, B=B, C=C, states=states, Acs=Acs,
           dy=dy, dhT=dhT)
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, nt = s // chunk, chunk // 64
    dev = x.device

    def out(i, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev) if needs[i] \
            else None
    dx = out(0, x.shape, BF16)
    ddt = out(1, dt.shape, F32)
    dla = out(2, dt.shape, F32)
    dB = out(3, B.shape, BF16)
    dC = out(4, C.shape, BF16)
    dh0 = out(5, (b, h, p, n), F32)
    scratch = dict(
        V=(states.shape, F32),                           # V, then dU
        dAq=(Acs.shape, F32),
        dTs=((b, h, nc, p * n // PASS_ELEMS), F32),
        dCB=((b, nc, -(-h // HEAD_GROUP), chunk, chunk), F32),
        dA=((b, nc, h, nt, chunk), F32),
        dT=((b, nc, h, nt), F32))
    work = {k: torch.empty(shape, dtype=dtype, device=dev)
            for k, (shape, dtype) in scratch.items()}
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.ssd_bwd_launch(
            *map(build.ptr, (x, dt, B, C, states, Acs, dy, dhT, dx, ddt, dla,
                             dB, dC, dh0)),
            *map(build.ptr, work.values()),
            b, s, h, chunk, n, build.stream_handle(dev))
    build.check_launch(rc, "ssd_bwd")
    ssd_bwd.launches += 1
    kernel_work("ssd_bwd", plain_flops(x, B, chunk, True),
                [t for t in (x, dt, B, C, states, Acs, dy, dhT, dx, ddt, dla,
                             dB, dC, dh0, *work.values()) if t is not None])
    return dx, ddt, dla, dB, dC, dh0


ssd_fwd.launches = 0
ssd_bwd.launches = 0
