"""The Mamba2 SSD's chunked-scan kernels (B14, ``kernels/ssd.py``).

On the CPU: which calls of ``ssd_chunked`` take the kernels (CUDA bf16 x
at head dim 64, chunk and state zamba2's (64, 64) or granite's (256,
128), the chunk dividing the length; every other call keeps the plain form and leaves the kernels' counters),
the wrappers' checks, the plain function in the kernels' layouts
(``ssd_fwd_plain``: ``ssd_chunked``'s bits), the kernels' stages of the
backward in plain PyTorch (``ssd_bwd_plain``) against autograd, the
kernel route's autograd glue with the plain versions standing in for the
kernels (its backward in the span ``obs.ssd_bwd``), and the FLOPs it
reports to ``OpCost``.

On the card (marked ``cuda``; ``pytest -m cuda
tests/test_torch_ssd_kernel.py -s`` prints each case's gaps): the kernels
against the plain form (``ssd_fwd_plain`` and its autograd on the card)
at granite's (chunk 256, state 128) and zamba2's (64, 64) shapes, cut in
batch, length and heads, with a nonzero h0 and a gradient of h_final: y,
h_final and all six gradients, each gap the norm of the difference over
the plain form's norm.  Each output has its own limit (``GAP``), a few
times the largest reading on an H100: see its comments.  Also: a chunk whose log-decays
sum below -88.7 (finite gradients, the plain form's), two calls give the
same bits, and no output lies farther from the f32 ``ssd_scan`` than the
plain form's does.
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ssd
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import mamba

BF16, F32 = torch.bfloat16, torch.float32
NAMES = ("x", "dt", "la", "B", "C", "h0")


def _inputs(dtype=BF16, b=2, s=32, h=3, p=8, n=6, seed=1, decay=0.5,
            device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g).to(dtype)
    dt = torch.rand(b, s, h, generator=g) * 0.5 + 0.05
    la = -torch.rand(b, s, h, generator=g) * decay
    B = torch.randn(b, s, n, generator=g).to(dtype)
    C = torch.randn(b, s, n, generator=g).to(dtype)
    h0 = torch.randn(b, h, p, n, generator=g)
    return [t.to(device) for t in (x, dt, la, B, C, h0)]


def _like(device="cuda", dtype=BF16, p=64, n=128, s=512):
    return (SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                            shape=(2, s, 4, p)),
            SimpleNamespace(shape=(2, s, n)))


@pytest.mark.parametrize("case,chunk,want", [
    (dict(), 256, True),
    (dict(n=64), 64, True),
    (dict(n=128), 64, False),           # pairs no config uses
    (dict(n=64), 256, False),
    (dict(dtype=F32), 256, False),
    (dict(dtype=torch.float16), 256, False),
    (dict(device="cpu"), 256, False),
    (dict(p=80), 256, False),
    (dict(n=96), 256, False),
    (dict(), 128, False),
    (dict(s=384), 256, False),          # the chunk does not divide: scan
])
def test_the_kernels_take_cuda_bf16_at_their_shapes(case, chunk, want):
    x, B = _like(**case)
    assert mamba.takes_kernel(x, B, chunk) is want


def _counts():
    return (mamba.ssd_chunked.calls, mamba.ssd_chunked.kernel_calls,
            ssd.ssd_fwd.launches, ssd.ssd_bwd.launches)


@pytest.mark.parametrize("dtype,s,chunk", [(BF16, 32, 8), (F32, 32, 8),
                                           (BF16, 20, 8)])
def test_cpu_calls_keep_the_plain_form(dtype, s, chunk):
    ins = _inputs(dtype, s=s)
    c0 = _counts()
    y, hT = mamba.ssd_chunked(*ins, chunk)
    assert _counts() == (c0[0] + 1,) + c0[1:]
    if s % chunk:
        want = mamba.ssd_scan(*ins)
    else:
        want = ssd.ssd_fwd_plain(*ins, chunk)[:2]
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])


def _gap(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("s,chunk,decay", [(32, 8, 0.5), (64, 16, 0.5),
                                           (16, 16, 30.0)])
def test_the_plain_function_in_the_kernels_layout_is_ssd_chunked(
        dtype, s, chunk, decay):
    """``ssd_chunked``'s plain route gives ``ssd_fwd_plain``'s y and
    h_final to the bit; its states are the scan's state before each chunk
    and Acs the in-chunk cumsum of la, which a given Acs replaces."""
    ins = _inputs(dtype, s=s, decay=decay)
    y, hT = mamba.ssd_chunked(*ins, chunk)
    py, phT, states, Acs = ssd.ssd_fwd_plain(*ins, chunk)
    assert torch.equal(y, py) and torch.equal(hT, phT)
    fed = ssd.ssd_fwd_plain(*ins, chunk, Acs=Acs.clone())
    assert all(torch.equal(a, b) for a, b in zip(fed, (py, phT, states,
                                                       Acs)))
    other = ssd.ssd_fwd_plain(*ins, chunk, Acs=Acs * 0.5)
    assert not torch.equal(other[1], phT)
    assert torch.equal(states[:, 0], ins[5])
    # in bf16 the chunked form rounds w and w·x, the scan does not
    limit = 1e-5 if dtype == F32 else 5e-3
    for c in range(1, s // chunk):
        _y, h = mamba.ssd_scan(*[t[:, :c * chunk] for t in ins[:5]], ins[5])
        assert _gap(states[:, c], h) <= limit
    la = ins[2].double().reshape(2, s // chunk, chunk, 3).transpose(2, 3)
    assert Acs.is_contiguous()
    torch.testing.assert_close(Acs.double(), torch.cumsum(la, dim=3),
                               rtol=1e-6, atol=1e-6)


def _autograd(fn, ins, dy, dhT):
    xs = [t.clone().requires_grad_() for t in ins]
    y, hT = fn(*xs)
    torch.autograd.backward((y, hT), (dy, dhT))
    return [y.detach(), hT.detach()] + [t.grad for t in xs]


@pytest.mark.parametrize("dtype,decay,limit", [
    (F32, 0.5, 1e-6),        # f32: the same arithmetic, other sum orders
    (F32, 30.0, 1e-6),       # past the exp overflow: finite, the same
    (BF16, 0.5, 6e-3),       # autograd rounds dx, dB, dC and dM to bf16
    (BF16, 30.0, 6e-3),
])
def test_the_kernels_stages_of_the_backward_are_autograds(dtype, decay,
                                                          limit):
    ins = _inputs(dtype, s=32, decay=decay)
    g = torch.Generator().manual_seed(7)
    dy = torch.randn(2, 32, 3, 8, generator=g)
    dhT = torch.randn(2, 3, 8, 6, generator=g)
    want = _autograd(lambda *z: mamba.ssd_chunked(*z, 8), ins, dy, dhT)
    _y, _h, states, Acs = ssd.ssd_fwd_plain(*ins, 8)
    x, dt, _la, B, C, _h0 = ins
    got = ssd.ssd_bwd_plain(x, dt, B, C, states, Acs, dy, dhT)
    for name, a, b in zip(NAMES, got, want[2:]):
        assert bool(torch.isfinite(a).all()), name
        assert _gap(a, b) <= limit, (name, _gap(a, b))


def test_the_wrappers_check_what_they_take():
    x, dt, la, B, C, h0 = _inputs(BF16, s=256, p=64, n=64, h=2)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ssd.ssd_fwd(x, dt, la, B, C, h0, 64)
    ok = dict(x=x, dt=dt, la=la, B=B, C=C, h0=h0)
    ssd.check_shapes("ssd_fwd", 64, **ok)
    bad = [(dict(x=x.float()), 64, "float32, expected"),
           (dict(dt=dt.to(BF16)), 64, "bfloat16, expected"),
           (dict(h0=h0[:, :1]), 64, "expected"),
           (dict(B=B[:, :128]), 64, "expected"),
           (dict(x=x.transpose(1, 2).contiguous().transpose(1, 2)), 64,
            "contiguous"),
           (dict(), 128, "chunk"),
           (dict(B=B[..., :32], C=C[..., :32]), 64, "pairs"),
           (dict(x=x[..., :32], h0=h0[:, :, :32]), 64, "x")]
    for change, chunk, match in bad:
        with pytest.raises(ValueError, match=match):
            ssd.check_shapes("ssd_fwd", chunk, **{**ok, **change})


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel route on the CPU: the plain versions stand in for the
    kernels, counting as they do; dx, dB, dC rounded to bf16 as the
    kernels round them."""
    def fwd(x, dt, la, B, C, h0, chunk):
        assert all(t.is_contiguous() for t in (x, dt, la, B, C, h0))
        fwd.launches += 1
        return ssd.ssd_fwd_plain(x, dt, la, B, C, h0, chunk)

    def bwd(x, dt, B, C, states, Acs, dy, dhT, needs):
        bwd.launches += 1
        bwd.needs = tuple(needs)
        grads = ssd.ssd_bwd_plain(x, dt, B, C, states, Acs, dy, dhT)
        return tuple(None if not need else
                     g.to(BF16) if name in ("x", "B", "C") else g
                     for name, g, need in zip(NAMES, grads, needs))
    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(mamba, "takes_kernel", lambda *a, **kw: True)
    monkeypatch.setattr(ssd, "ssd_fwd", fwd)
    monkeypatch.setattr(ssd, "ssd_bwd", bwd)
    return fwd, bwd


def test_the_kernel_route_glue(plain_kernels):
    fwd, bwd = plain_kernels
    ins = _inputs(BF16, s=32)
    # B and C as the mixer slices them: views into one (b, s, 2n) tensor
    bc = torch.cat([ins[3], ins[4]], dim=-1)
    calls, kernel = mamba.ssd_chunked.calls, mamba.ssd_chunked.kernel_calls
    xs = [t.clone().requires_grad_() for t in ins[:3]] + [
        bc.clone().requires_grad_()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, hT = mamba.ssd_chunked(xs[0], xs[1], xs[2], xs[3][..., :6],
                                  xs[3][..., 6:], ins[5], 8)
        torch.sum(y * y).backward()
    assert (fwd.launches, bwd.launches) == (1, 1)
    assert mamba.ssd_chunked.calls == calls + 1
    assert mamba.ssd_chunked.kernel_calls == kernel + 1
    assert bwd.needs == (True, True, True, True, True, False)
    want_y, want_h = ssd.ssd_fwd_plain(*ins, 8)[:2]
    assert torch.equal(y, want_y) and torch.equal(hT, want_h)
    plain = _autograd(lambda *z: mamba.ssd_chunked(*z, 8), ins,
                      2 * want_y, torch.zeros_like(want_h))
    got = [t.grad for t in xs[:3]] + [xs[3].grad[..., :6],
                                      xs[3].grad[..., 6:]]
    for name, a, b in zip(NAMES, got, plain[2:7]):
        assert a.dtype == b.dtype, name
        assert _gap(a, b) <= 6e-3, (name, _gap(a, b))
    spans = [e for e in prof.events() if e.name == "obs.ssd_bwd"]
    assert len(spans) == 1


def test_the_kernel_route_without_a_gradient_of_h_final(plain_kernels):
    ins = _inputs(BF16, s=16)
    xs = [t.clone().requires_grad_() for t in ins]
    y, _hT = mamba.ssd_chunked(*xs, 8)
    torch.sum(y).backward()
    assert all(t.grad is not None for t in xs)
    _fwd, bwd = plain_kernels
    assert bwd.needs == (True,) * 6


@pytest.mark.parametrize("s,chunk,n", [(32, 8, 6), (64, 16, 4)])
def test_plain_flops_are_what_op_cost_counts(s, chunk, n):
    ins = [t.requires_grad_() for t in _inputs(F32, s=s, n=n)]
    with OpCost() as fwd:
        y, hT = mamba.ssd_chunked(*ins, chunk)
    with OpCost() as bwd:
        torch.autograd.backward((y, hT), (torch.ones_like(y),
                                          torch.ones_like(hT)))
    assert fwd.flops == ssd.plain_flops(ins[0], ins[3], chunk, False) > 0
    assert bwd.flops == ssd.plain_flops(ins[0], ins[3], chunk, True)


# ------------------------------------------------------------------ the card

# Limits on the gap of each output to the plain form on the card, each a
# few times the largest reading on an NVIDIA H100 80GB HBM3 (700 W) over
# the six cases of test_the_kernels_match_the_plain_form.  y and h_final
# differ where an f32 sum of another order (the in-chunk cumsum, C·Bᵀ)
# rounds w or M to another bf16 than the plain form's: rare at these cut
# shapes and fixed seeds (at full width and other seeds h_final read up to
# 1.4e-4; chip_smoke.py's phase 20 holds it there to the plain form fed
# the kernels' cumsum).  The gradients of x, dt, la, B and C differ more:
# the plain form rounds dx, dB, dC and dM to bf16, the kernels round dx,
# dB and dC once and keep dM in f32.
GAP = {"y": 5e-4,           # read 5.1e-7 to 1.1e-4
       "h_final": 5e-7,     # read 5.7e-8 to 1.6e-7
       "x": 1e-2,           # read 6.9e-4 to 3.1e-3
       "dt": 7e-3,          # read 1.6e-3 to 2.6e-3
       "la": 6e-3,          # read 6.3e-4 to 1.4e-3
       "B": 1e-2,           # read 2.7e-3 to 3.2e-3
       "C": 1e-2,           # read 2.6e-3 to 3.0e-3
       "h0": 1.5e-6}        # read 2.0e-7 to 3.6e-7

CASES = {
    "granite": dict(b=1, s=1024, h=4, n=128, chunk=256),
    "zamba2": dict(b=2, s=512, h=3, n=64, chunk=64),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _card_inputs(dev, case, seed=0, decay=None):
    c = CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, h, n = c["b"], c["s"], c["h"], c["n"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = randn(b, s, h, 64).to(BF16)
    # granite's init: dt about softplus(-4.6 + noise), A = -8
    dt = torch.nn.functional.softplus(randn(b, s, h) - 4.6)
    la = -8.0 * dt if decay is None else -decay * torch.rand(
        (b, s, h), generator=g, device=dev)
    B = randn(b, s, n).to(BF16)
    C = randn(b, s, n).to(BF16)
    h0 = randn(b, h, 64, n)
    dy = randn(b, s, h, 64)
    dhT = randn(b, h, 64, n)
    return [x, dt, la, B, C, h0], dy, dhT


def _kernel_route(ins, dy, dhT, chunk):
    return _autograd(lambda *z: mamba._SSDKernel.apply(*z, chunk), ins, dy,
                     dhT)


def _plain_route(ins, dy, dhT, chunk):
    return _autograd(lambda *z: ssd.ssd_fwd_plain(*z, chunk)[:2], ins, dy,
                     dhT)


def _scan_route(ins, dy, dhT):
    f32 = [t.float() for t in ins]
    return _autograd(mamba.ssd_scan, f32, dy, dhT)


OUTS = ("y", "h_final") + NAMES


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("decay", [None, 0.75, 0.01])
def test_the_kernels_match_the_plain_form(cuda_device, case, decay):
    """decay None: granite's init, a chunk of 64 sums near -5, so each
    chunk's state reaches y and h_final through one or two chunks.
    decay 0.75: log-decays of mean -0.375, a chunk of 256 sums near -96
    and one of 64 near -24 (the overflow case at granite's chunk).
    decay 0.01: a chunk of 64 sums near -0.3, so h0 and every chunk's
    decay and state reach h_final and the last chunks' y."""
    chunk = CASES[case]["chunk"]
    ins, dy, dhT = _card_inputs(cuda_device, case, decay=decay)
    f0, b0 = ssd.ssd_fwd.launches, ssd.ssd_bwd.launches
    got = _kernel_route(ins, dy, dhT, chunk)
    assert (ssd.ssd_fwd.launches - f0, ssd.ssd_bwd.launches - b0) == (1, 1)
    want = _plain_route(ins, dy, dhT, chunk)
    gaps = {k: _gap(a, b) for k, a, b in zip(OUTS, got, want)}
    print(f"ssd {case} decay {decay}: gaps to the plain form {gaps}")
    for k, a, b in zip(OUTS, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert bool(torch.isfinite(a).all()), k
        assert gaps[k] <= GAP[k], (k, gaps[k])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_two_calls_give_the_same_bits(cuda_device, case):
    chunk = CASES[case]["chunk"]
    ins, dy, dhT = _card_inputs(cuda_device, case, seed=3)
    first = _kernel_route(ins, dy, dhT, chunk)
    again = _kernel_route(ins, dy, dhT, chunk)
    for k, a, b in zip(OUTS, first, again):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_no_output_is_farther_from_the_scan(cuda_device, case):
    """The f32 scan of the same inputs is the yardstick: the kernels
    round M and w·x where the plain form does and keep f32 where its
    backward rounds to bf16, so each output lies no farther from it."""
    chunk = CASES[case]["chunk"]
    ins, dy, dhT = _card_inputs(cuda_device, case, seed=5)
    got = _kernel_route(ins, dy, dhT, chunk)
    want = _plain_route(ins, dy, dhT, chunk)
    scan = _scan_route(ins, dy, dhT)
    far = {k: (_gap(a, s), _gap(b, s))
           for k, a, b, s in zip(OUTS, got, want, scan)}
    print(f"ssd {case}: (kernels, plain form) from the f32 scan {far}")
    for k, (kern, plain) in far.items():
        assert kern <= plain * SCAN_SLACK, (k, kern, plain)


# The kernels' and the plain form's roundings of M and w·x differ where
# their f32 values differ in the last bits (sum orders), so on y and
# h_final the two distances from the scan are equal only nearly: the
# kernels' read 1.00004 and 1.000002 times the plain form's at both
# shapes (H100), every gradient 0.0006 to 0.95 times.
SCAN_SLACK = 1.001


@pytest.mark.cuda
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    ins, dy, dhT = _card_inputs(cuda_device, "zamba2")
    x, dt, la, B, C, h0 = ins
    with pytest.raises(ValueError, match="float32, expected"):
        ssd.ssd_fwd(x.float(), dt, la, B, C, h0, 64)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_fwd(x, dt, la, B, C, h0, 128)
    with pytest.raises(ValueError, match="is on"):
        ssd.ssd_fwd(x, dt.cpu(), la, B, C, h0, 64)


@pytest.mark.cuda
def test_ssd_chunked_sends_cuda_bf16_to_the_kernels(cuda_device):
    ins, _dy, _dhT = _card_inputs(cuda_device, "zamba2")
    calls, kernel = mamba.ssd_chunked.calls, mamba.ssd_chunked.kernel_calls
    y, hT = mamba.ssd_chunked(*ins, 64)
    assert (mamba.ssd_chunked.calls, mamba.ssd_chunked.kernel_calls) == (
        calls + 1, kernel + 1)
    want = ssd.ssd_fwd_plain(*ins, 64)
    assert _gap(y, want[0]) <= GAP["y"]
    assert _gap(hT, want[1]) <= GAP["h_final"]
    mamba.ssd_chunked(ins[0].float(), *ins[1:], 64)     # f32: plain
    mamba.ssd_chunked(ins[0][:, :448], ins[1][:, :448], ins[2][:, :448],
                      ins[3][:, :448], ins[4][:, :448], ins[5], 256)
    assert mamba.ssd_chunked.kernel_calls == kernel + 1
