"""Which attention calls take the flash attention kernels, and the glue
around them, on the CPU.

``flash_attention`` sends a call to the kernels (``kernels/flash_attn.py``)
only for CUDA tensors, all bf16, at head_dim 64 or 128, at any length;
every other call keeps the einsum path (``_FlashCore``, or
``chunked_attention`` for ragged lengths) and leaves the kernels'
counters as they were.  The kernel route's autograd glue
(``_FlashKernel``: layouts, the f32 gradients' rounding, the counters)
is driven here with the kernels' plain versions standing in for them,
and must give ``_FlashCore``'s bits.  Both forwards and both backwards
run in the span ``obs.attn``.  A kernel reports to ``OpCost`` the FLOPs
its plain version's einsums count.  The kernels' exact three-term bf16
split of an f32 operand is checked in PyTorch.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import flash_attn as fa
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import attention as A
from repro_torch.obs.profiling import kernel_work, scope

BF16, F32 = torch.bfloat16, torch.float32


def _like(device="cuda", dtype=BF16, hd=64):
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                           shape=(2, 32, 4, hd))


@pytest.mark.parametrize("case,want", [
    (dict(), True),
    (dict(hd=128), True),
    (dict(dtype=F32), False),
    (dict(dtype=torch.float16), False),
    (dict(hd=32), False),
    (dict(hd=96), False),
    (dict(device="cpu"), False),
])
def test_the_kernels_take_cuda_bf16_at_two_head_dims(case, want):
    t = _like(**case)
    assert A.takes_kernel(t, t, t) is want


def test_a_negative_offset_keeps_the_einsum_path():
    t = _like()
    assert A.takes_kernel(t, t, t, q_offset=0)
    assert not A.takes_kernel(t, t, t, q_offset=-1)


def _qkv(dtype, hd, s=32, hq=4, hkv=2, b=2, skv=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    skv = s if skv is None else skv
    q = torch.randn((b, s, hq, hd), generator=g).to(dtype)
    k = torch.randn((b, skv, hkv, hd), generator=g).to(dtype)
    v = torch.randn((b, skv, hkv, hd), generator=g).to(dtype)
    return q, k, v


def _counts():
    return (A.flash_attention.calls, A.flash_attention.kernel_calls,
            fa.flash_attn_fwd.launches, fa.flash_attn_bwd.launches)


def _grads(fn, q, k, v):
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*xs)
    torch.sum(torch.square(out.float())).backward()
    return [out.detach()] + [t.grad for t in xs]


@pytest.mark.parametrize("dtype,hd,s", [(BF16, 64, 32), (F32, 64, 32),
                                        (BF16, 32, 32), (F32, 128, 16),
                                        (BF16, 64, 24)])
def test_cpu_calls_keep_the_einsum_path(dtype, hd, s):
    q, k, v = _qkv(dtype, hd, s=s)
    c0 = _counts()
    got = _grads(lambda *x: A.flash_attention(*x, True, 16, 0), q, k, v)
    c1 = _counts()
    assert c1 == (c0[0] + 1,) + c0[1:]
    if s % 16 == 0:
        want = _grads(lambda *x: A._FlashCore.apply(*x, True, 16, 0),
                      q, k, v)
    else:
        want = _grads(lambda *x: A.chunked_attention(
            *x, causal=True, chunk=16), q, k, v)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel route on the CPU: the kernels' plain versions stand in
    for the kernels, counting as they do."""
    def fwd(q, k, v, causal, q_offset, scale):
        assert scale is None
        fwd.launches += 1
        return fa.flash_attn_fwd_plain(q, k, v, causal, q_offset, chunk=16)

    def bwd(q, k, v, o, lse, dout, causal, q_offset, out_dtype, scale):
        assert scale is None
        assert dout.dtype == q.dtype and dout.is_contiguous()
        bwd.launches += 1
        grads = fa.flash_attn_bwd_plain(q, k, v, o, lse, dout, causal,
                                        q_offset, chunk=16)
        return tuple(g.to(out_dtype) for g in grads)
    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(A, "takes_kernel", lambda *a, **kw: True)
    monkeypatch.setattr(fa, "flash_attn_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attn_bwd", bwd)
    return fwd, bwd


@pytest.mark.parametrize("hd,causal,q_offset,hq,hkv,s,skv", [
    (64, True, 0, 4, 2, 32, 32),
    (128, True, 16, 4, 1, 16, 32),
    (64, False, 0, 6, 2, 16, 48),
    (64, False, 0, 4, 4, 28, 75),        # whisper's cross attention, cut
    (64, True, 0, 4, 2, 24, 24),         # a length the chunk does not divide
])
def test_the_kernel_route_gives_flash_core_bits(plain_kernels, hd, causal,
                                                q_offset, hq, hkv, s, skv):
    fwd, bwd = plain_kernels
    q, k, v = _qkv(BF16, hd, s=s, hq=hq, hkv=hkv, skv=skv, seed=hd)
    calls, kernel_calls = (A.flash_attention.calls,
                           A.flash_attention.kernel_calls)
    got = _grads(lambda *x: A.flash_attention(*x, causal, 16, q_offset),
                 q, k, v)
    assert (fwd.launches, bwd.launches) == (1, 1)
    assert A.flash_attention.calls == calls + 1
    assert A.flash_attention.kernel_calls == kernel_calls + 1
    # the plain stand-ins take a ragged length as one chunk, as the
    # kernels take any length
    chunk = 16 if skv % 16 == 0 else skv
    want = _grads(lambda *x: A._FlashCore.apply(*x, causal, chunk,
                                                q_offset), q, k, v)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == BF16
        assert torch.equal(a, b)


def test_the_plain_kernels_keep_flash_core_layouts():
    """o and lse of ``flash_attn_fwd_plain`` are ``_FlashCore``'s, row
    r of KV head h being position r // g of head h * g + r % g."""
    q, k, v = _qkv(BF16, 64, hq=6, hkv=2)
    out, o, lse = fa.flash_attn_fwd_plain(q, k, v, True, 0, chunk=16)
    qg = fa.scaled_group(q, 2)
    o5, m, l = fa.online_softmax(qg, k, v, causal=True, chunk=16,
                                 q_offset=0)
    lse5 = m + torch.log(torch.clamp_min(l, 1e-30))     # (b, hkv, g, sq)
    b, sq, hq, hd = q.shape
    for r in (0, 1, 2, 5, 17, sq * 3 - 1):
        pos, head = divmod(r, 3)
        assert torch.equal(lse[:, 1, r], lse5[:, 1, head, pos])
        assert torch.equal(o[:, pos, 3 + head], o5[:, 1, head, pos])
    assert torch.equal(out, o.to(BF16))


def test_the_wrappers_raise_off_the_card():
    q, k, v = _qkv(BF16, 64)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fa.flash_attn_fwd(q, k, v, True, 0)


@pytest.mark.parametrize("route", ["einsum", "kernel"])
def test_attention_runs_in_its_span_forward_and_backward(request, route):
    if route == "kernel":
        request.getfixturevalue("plain_kernels")
    q, k, v = _qkv(BF16, 64)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = A.flash_attention(*xs, True, 16, 0)
        torch.sum(out.float()).backward()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name == "obs.attn")
    assert len(spans) == 2                   # the forward, the backward
    inside = [e.name for e in prof.events()
              if e.name in ("aten::exp", "aten::einsum")
              and not any(a <= e.time_range.start <= b for a, b in spans)]
    assert inside == []


@pytest.mark.parametrize("causal,s,skv,hq,hkv", [(True, 32, 32, 4, 2),
                                                 (False, 16, 48, 6, 2)])
def test_plain_flops_are_what_op_cost_counts_of_the_einsums(causal, s, skv,
                                                            hq, hkv):
    q, k, v = _qkv(F32, 64, s=s, hq=hq, hkv=hkv, skv=skv)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    with OpCost() as fwd:
        out = A._FlashCore.apply(*xs, causal, 16, 0)
    with OpCost() as bwd:
        out.backward(torch.ones_like(out))
    assert fwd.flops == fa.plain_flops(q, k, False) > 0
    assert bwd.flops == fa.plain_flops(q, k, True)


def test_a_kernel_reports_its_work_to_op_cost_in_its_span():
    q, k, v = _qkv(BF16, 64)
    kernel_work("k", 1.0, (q,))              # no dispatch mode: nothing
    with OpCost(sources=True) as cost:
        with scope("obs.attn"):
            kernel_work("flash_attn_fwd", 12.0, (q, k, v))
        kernel_work("flash_attn_bwd", 30.0, (q,))
    rows = {(r.op, r.source.split(" ")[0]): r for r in cost.rows.values()}
    row = rows[("flash_attn_fwd", "obs.attn")]
    assert (row.count, row.flops, row.bytes) == (
        1, 12.0, q.nbytes + k.nbytes + v.nbytes)
    assert rows[("flash_attn_bwd", "-")].flops == 30.0
    assert (cost.flops, cost.bytes) == (42.0, row.bytes + q.nbytes)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-20, 3e4])
def test_three_bf16_parts_sum_to_the_f32_value(scale):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): the
    parts sum to x exactly, so the three products with a bf16 operand
    sum to the f32 product; one bf16 part alone does not."""
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(4096, generator=g) * scale).to(F32)
    x[::7] *= -1
    hi = x.to(BF16).float()
    r = x - hi
    mid = r.to(BF16).float()
    lo = (r - mid).to(BF16).float()
    assert torch.equal(hi.double() + mid.double() + lo.double(),
                       x.double())
    v = torch.randn(4096, generator=g).to(BF16).double()
    parts = (hi.double() * v) + (mid.double() * v) + (lo.double() * v)
    assert torch.equal(parts, x.double() * v)
    assert not torch.equal(hi.double() * v, x.double() * v)
    assert np.all(np.isfinite(lo.numpy()))
