"""The port's ``hybrid_moe`` family (GraniteMoeHybrid, ``models/granite.py``)
against the benchmark's plain float32 reference
(``bench/reference/granite_hybrid.py``) on the CPU, at a tiny size with
the published layer pattern's first period (9 Mamba2 layers and one
attention layer at index 5), 4 experts held of 8, top-2.

Held here:

* the stack's loss and every gradient against the reference, for both
  shares of the experts (rtol 1e-5 for the loss, 1e-4 of each leaf's
  norm for its gradient: f32 sums in another order), with and without
  remat, and three ``make_train_step`` steps on the normal path;
* the SSD: the program's chunked form at chunk 256 and the reference's
  chunk-64 dual form against the sequential recurrence;
* the gated norm gate first (``mamba_gate_first``), and zamba2's order,
  norm first, unchanged to the bit against the parent's formula;
* expert shares: the parts that every share gives, the shared expert
  counted once, add up to the uncut reference's whole layer;
* the dropless layer under a router forced onto one expert: every
  assignment computed, the counter ``expert_rows`` counting them;
* the grouped products' route (``torch._grouped_mm``, bf16) with the
  rows past the held ones filled with NaN: no output or gradient reads
  them;
* the softmax scale on both attention paths, and the default calls
  (qwen2's) unchanged to the bit;
* the logits' divisor of the chunked loss; the preset's sizes.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core.partition import leaf_paths
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.ref import true_div
from repro_torch.models import attention as A
from repro_torch.models import common as cm
from repro_torch.models import granite, mamba, moe
from repro_torch.models.config import ArchConfig
from repro_torch.train.steps import family_module, make_train_step

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import f32_matmuls  # noqa: E402
from reference import granite_hybrid as ref  # noqa: E402

PERIOD = tuple("attention" if i == 5 else "mamba" for i in range(10))
TINY = ArchConfig(
    name="granite-tiny", family="hybrid_moe", n_layers=10, d_model=64,
    n_heads=4, n_kv=2, head_dim=16, d_ff=32, vocab_size=512,
    vocab_multiple=64, n_experts=8, experts_held=4, top_k=2,
    shared_d_ff=48, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    conv_kernel=4, rwkv_chunk=16, mamba_gate_first=True,
    layer_types=PERIOD,
    attention_multiplier=1 / 16, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
    loss_chunk=32, attn_chunk=16, compute_dtype="float32")


def _tree(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _params(cfg, seed=1):
    """Seeded params with every vector leaf (norms, biases, A_log,
    dt_bias, D) moved off its constant start, so each path carries a
    gradient of its own."""
    g = torch.Generator().manual_seed(seed)
    flat = dict(leaf_paths(granite.init(g, cfg, device="cpu")))
    for path, leaf in flat.items():
        if leaf.dim() <= 2 and not any(k in path for k in
                                       ("proj", "table", "router")):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=g))
    return flat


def _batch(cfg, b=2, s=128, seed=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (b, s), generator=g),
            torch.randint(0, cfg.vocab_size, (b, s), generator=g))


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------- the stack
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("rank", [0, 1])
def test_loss_and_every_gradient_against_the_reference(rank, remat):
    cfg = dataclasses.replace(TINY, expert_rank=rank)
    flat = _params(cfg)
    tokens, labels = _batch(cfg)
    live = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss = granite.train_loss(cfg, _tree(live),
                              {"tokens": tokens, "labels": labels},
                              remat=remat)
    grads = torch.autograd.grad(loss, list(live.values()))
    P = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    with f32_matmuls():
        want = ref.loss(dataclasses.asdict(cfg), P, tokens, labels)
        wgrads = torch.autograd.grad(want, list(P.values()))
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    for path, got, w in zip(live, grads, wgrads):
        assert _rel(got, w) <= 1e-4, path


def test_three_steps_through_make_train_step():
    cfg = dataclasses.replace(TINY, vocab_size=2048)
    ts = make_train_step(cfg, optimizer="cs_adam", lr=1e-3, remat=True,
                         device="cpu")
    params = ts.init_fn(torch.Generator().manual_seed(0))
    state = ts.optimizer.init(params)
    tokens, labels = _batch(cfg)
    losses = []
    for _ in range(3):
        params, state, metrics = ts.step_fn(
            params, state, {"tokens": tokens, "labels": labels})
        losses.append(float(metrics["loss"]))
    assert all(map(math.isfinite, losses)) and losses[2] < losses[0]
    assert family_module(cfg) is granite


def test_the_preset_is_the_published_model():
    cfg = configs.get("granite-4.0-h-small")
    assert cfg.name not in configs.ARCH_IDS
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.ssm_heads, cfg.ssm_d_inner, cfg.vocab) == (128, 8192,
                                                            100352)
    p = dict(leaf_paths(granite.init(None, cfg, device="meta")))
    assert p["layers/ffn/w_gate"].shape == (40, 72, 4096, 768)
    assert p["layers/mamba/z_proj"].shape == (36, 4096, 8192)
    assert p["layers/attn/wk"].shape == (4, 4096, 1024)
    assert sum(x.numel() for x in p.values()) == 32_618_379_776


# --------------------------------------------------------------- the SSD
def _ssd_inputs(s=512, b=1, h=2, p=4, n=8, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g)
    dt = F.softplus(torch.randn((b, s, h), generator=g) - 3.0)
    la = -torch.exp(torch.randn((h,), generator=g)) * dt
    B = torch.randn((b, s, n), generator=g)
    C = torch.randn((b, s, n), generator=g)
    return x, dt, la, B, C


@pytest.mark.parametrize("form", ["program, chunk 256",
                                  "reference, chunk 64"])
def test_the_ssd_forms_against_the_recurrence(form):
    x, dt, la, B, C = _ssd_inputs()
    h0 = torch.zeros((1, 2, 4, 8))
    want, _ = mamba.ssd_scan(x, dt, la, B, C, h0)
    if form.startswith("program"):
        got, _ = mamba.ssd_chunked(x, dt, la, B, C, h0, 256)
    else:
        got = ref.ssd(x * dt[..., None], la, B, C, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- the gated norm order
def _mixer_inputs(cfg, seed=4):
    g = torch.Generator().manual_seed(seed)
    p = {k: v[0] for k, v in mamba.mamba_init(g, cfg, lead=(1,),
                                              device="cpu").items()}
    p["gn"] = p["gn"] + 0.1 * torch.randn(p["gn"].shape, generator=g)
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    zero = {k: v[0] for k, v in mamba.mamba_zero_state(
        cfg, 2, 1, device="cpu").items()}
    return p, x, zero


def _parent_mamba_apply(cfg, p, x, state):
    """``mamba_apply`` as the parent commit wrote it (norm, then the
    gate), chunked mode."""
    b, s, _d = x.shape
    di, n, hds, hp = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_head_dim)
    dt_, f32 = x.dtype, torch.float32
    h_in = cm.rmsnorm(x, p["ln"])
    z = h_in @ p["z_proj"].to(dt_)
    xr = h_in @ p["x_proj"].to(dt_)
    bc = h_in @ p["bc_proj"].to(dt_)
    dt_raw = h_in @ p["dt_proj"].to(dt_)
    xr, _ = mamba._causal_conv(xr, p["conv_w_x"], p["conv_b_x"],
                               state["conv_x"])
    bc, _ = mamba._causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"],
                               state["conv_bc"])
    xs = xr.reshape(b, s, hds, hp)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    la = -torch.exp(p["A_log"])[None, None] * dt
    y, _ = mamba.ssd_chunked(xs, dt, la, bc[..., :n], bc[..., n:],
                             state["h"], cfg.rwkv_chunk)
    y = (y + p["D"][None, None, :, None] * xs.to(f32)).reshape(b, s, di)
    y = cm.rmsnorm(y, p["gn"]) * F.silu(z.to(f32))
    return x + y.to(dt_) @ p["out_proj"].to(dt_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_keeps_its_order_to_the_bit(dtype):
    cfg = configs.get("zamba2_2_7b").reduced(compute_dtype=dtype,
                                             rwkv_chunk=8)
    assert not cfg.mamba_gate_first
    p, x, zero = _mixer_inputs(cfg)
    x = x.to(cfg.dtype)
    got, _ = mamba.mamba_apply(cfg, p, x, zero, "chunked")
    assert torch.equal(got, _parent_mamba_apply(cfg, p, x, zero))


def test_granite_gates_before_the_norm():
    cfg = dataclasses.replace(TINY, d_model=64)
    p, x, zero = _mixer_inputs(cfg)
    h = cm.rmsnorm(x, p["ln"])
    got, _ = mamba.mamba_mixer(cfg, p, h, zero, "chunked")
    norm_first = dataclasses.replace(cfg, mamba_gate_first=False)
    other, _ = mamba.mamba_mixer(norm_first, p, h, zero, "chunked")
    z = h @ p["z_proj"]
    want = cm.rmsnorm(_y_before_norm(cfg, p, h, zero) * F.silu(z), p["gn"],
                      cfg.norm_eps) @ p["out_proj"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert _rel(got, other) > 1e-2


def _y_before_norm(cfg, p, h, zero):
    """The mixer's y + D·x, before the gated norm."""
    b, s, _d = h.shape
    xr, _ = mamba._causal_conv(h @ p["x_proj"], p["conv_w_x"],
                               p["conv_b_x"], zero["conv_x"])
    bc, _ = mamba._causal_conv(h @ p["bc_proj"], p["conv_w_bc"],
                               p["conv_b_bc"], zero["conv_bc"])
    xs = xr.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    dt = F.softplus(h @ p["dt_proj"] + p["dt_bias"])
    la = -torch.exp(p["A_log"]) * dt
    n = cfg.ssm_state
    y, _ = mamba.ssd_scan(xs, dt, la, bc[..., :n], bc[..., n:], zero["h"])
    return (y + p["D"][:, None] * xs).reshape(b, s, -1)


# ------------------------------------------------------------ the experts
def _moe_case(held, seed=5, T=96):
    cfg = dataclasses.replace(TINY, experts_held=held)
    g = torch.Generator().manual_seed(seed)
    whole = moe.held_moe_init(g, dataclasses.replace(cfg, experts_held=0),
                              device="cpu")
    x = torch.randn((1, T, cfg.d_model), generator=g)
    return cfg, whole, x


def _share(whole, rank, held):
    lo = rank * held
    return dict(whole, **{k: whole[k][lo:lo + held]
                          for k in ("w_gate", "w_up", "w_down")})


def _flat_ffn(p):
    return {f"layers/ffn/{k}": v[None] for k, v in leaf_paths(p)}


@pytest.mark.parametrize("held", [1, 2, 4, 8])
def test_the_shares_add_up_to_the_whole_layer(held):
    cfg, whole, x = _moe_case(held)
    shares = cfg.n_experts // held
    parts = [moe.held_moe_apply(dataclasses.replace(cfg, expert_rank=r),
                                _share(whole, r, held), x)
             for r in range(shares)]
    sp = whole["shared"]
    shared = (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    got = sum(parts) - (shares - 1) * shared
    uncut = dataclasses.asdict(dataclasses.replace(cfg, experts_held=0))
    P = _flat_ffn(whole)
    with f32_matmuls():
        want = ref._moe(uncut, lambda k: P[f"layers/ffn/{k}"][0], x,
                        ref.F32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("forced", [1, 6])
def test_the_dropless_layer_drops_nothing(forced):
    """Every token's first choice forced onto expert ``forced`` (held by
    share 0, or by none): the layer computes each held assignment, where
    a capacity of 1.25 would drop most of them."""
    cfg, whole, x = _moe_case(4)
    whole["router"] = whole["router"].clone()
    whole["router"][:, forced] += 50.0 * x[0].mean(0) / x[0].mean(0).norm()
    x = x + 2.0 * x[0].mean(0)
    p = _share(whole, 0, 4)
    T = x.shape[1]
    eids = moe.held_route(cfg, p, x[0])[1]
    assert bool((eids[:, 0] == forced).all())
    counter = moe.expert_rows("cpu")
    before = int(counter)
    got = moe.held_moe_apply(cfg, p, x)
    assert int(counter) - before == int((eids < 4).sum())
    assert int((eids < 4).sum()) >= (T if forced < 4 else 0)
    P = _flat_ffn(p)
    with f32_matmuls():
        want = ref._moe(dataclasses.asdict(cfg),
                        lambda k: P[f"layers/ffn/{k}"][0], x, ref.F32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_no_row_past_the_held_ones_is_read(monkeypatch):
    """The grouped products' route, with every row that a group does not
    cover filled with NaN, gives the plain route's output and gradients:
    the layer masks those rows before any product or gradient reads
    them."""
    real = torch._grouped_mm

    def undefined_tail(x, w, offs=None):
        y = real(x, w, offs=offs)
        if x.dim() == 2 and w.dim() == 3:
            y = y.clone()
            y[int(offs[-1]):] = float("nan")
        return y

    cfg = dataclasses.replace(TINY, experts_held=2, expert_rank=1, top_k=3,
                              compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(6)
    p = moe.held_moe_init(g, cfg, device="cpu")
    x = torch.randn((2, 48, cfg.d_model), generator=g).to(torch.bfloat16)
    out = {}
    for route in ("kernel", "plain"):
        with monkeypatch.context() as m:
            if route == "kernel":
                m.setattr(torch, "_grouped_mm", undefined_tail)
                m.setattr(moe, "grouped_mm", moe._GroupedMM.apply)
            live = {k: v.clone().requires_grad_(True)
                    for k, v in leaf_paths(p)}
            xx = x.clone().requires_grad_(True)
            y = moe.held_moe_apply(cfg, _tree(live), xx)
            y.float().square().sum().backward()
            out[route] = [y.float(), xx.grad.float()] + [
                v.grad.float() for v in live.values()]
    for got, want in zip(out["kernel"], out["plain"]):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-2


# ------------------------------------------------------------- attention
def _qkv(hd=16, s=32, hq=4, hkv=2, seed=7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, s, hq, hd), generator=g),
            torch.randn((2, s, hkv, hd), generator=g),
            torch.randn((2, s, hkv, hd), generator=g))


def _naive(q, k, v, scale):
    g = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    s = (q.transpose(1, 2) @ k.transpose(-1, -2)) * scale
    n = q.shape[1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                      float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2)


def _grads(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    grads = torch.autograd.grad(out, xs, gout.to(out.dtype))
    return [out] + list(grads)


@pytest.mark.parametrize("path", ["plain", "kernel route"])
def test_the_softmax_scale_on_both_paths(path, monkeypatch):
    q, k, v = _qkv()
    scale = 1 / 128
    if path == "kernel route":
        def fwd(q, k, v, causal, q_offset, scale=None):
            return fa.flash_attn_fwd_plain(q, k, v, causal, q_offset,
                                           chunk=16, scale=scale)

        def bwd(q, k, v, o, lse, dout, causal, q_offset, out_dtype,
                scale=None):
            grads = fa.flash_attn_bwd_plain(q, k, v, o, lse, dout, causal,
                                            q_offset, chunk=16, scale=scale)
            return tuple(g.to(out_dtype) for g in grads)
        monkeypatch.setattr(A, "takes_kernel", lambda *a, **kw: True)
        monkeypatch.setattr(fa, "flash_attn_fwd", fwd)
        monkeypatch.setattr(fa, "flash_attn_bwd", bwd)
    got = _grads(lambda *x: A.flash_attention(*x, True, 16, scale=scale),
                 q, k, v)
    want = _grads(lambda *x: _naive(*x, scale), q, k, v)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    default = _grads(lambda *x: A.flash_attention(*x, True, 16), q, k, v)
    assert _rel(default[0], got[0]) > 1e-3


def test_the_default_scale_is_unchanged_to_the_bit():
    """qwen2's calls pass no scale: the queries are divided by √hd as the
    parent divided them, and the kernels get the scale they got."""
    q, k, v = _qkv(hd=64)
    parent = true_div(q.reshape(2, 32, 2, 2, 64).to(torch.float32),
                      float(np.sqrt(np.float32(64))))
    assert torch.equal(fa.scaled_group(q, 2), parent)
    assert fa.scale_of(64) == float(np.float32(1.0) / np.sqrt(
        np.float32(64)))
    got = A.flash_attention(q, k, v, True, 16)
    again = A._FlashCore.apply(q, k, v, True, 16, 0)
    assert torch.equal(got, again)


# ------------------------------------------------------------ the loss
def test_the_logits_divisor():
    g = torch.Generator().manual_seed(9)
    x = torch.randn((2, 64, 32), generator=g)
    table = torch.randn((128, 32), generator=g)
    labels = torch.randint(0, 128, (2, 64), generator=g)
    got = cm.chunked_softmax_xent(x, table, labels, 16, 16.0)
    want = cm.softmax_xent((x @ table.T) / 16.0, labels)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    plain = cm.chunked_softmax_xent(x, table, labels, 16)
    assert torch.equal(plain, cm.chunked_softmax_xent(x, table, labels, 16,
                                                      1.0))


@pytest.mark.cuda
def test_the_kernels_take_the_scale_on_the_card():
    """B10 at granite's shape (head_dim 128, a group of 4) and scale
    1/128 against its plain version at the same scale, within the card
    tests' tolerance for the kernels (1e-5 of each output's norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    q, dout = (torch.randn((1, 1024, 32, 128), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, 1024, 8, 128), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    scale = 1 / 128
    _out, o, lse = fa.flash_attn_fwd(q, k, v, True, 0, scale=scale)
    grads = fa.flash_attn_bwd(q, k, v, o, lse, dout, True, 0, scale=scale)
    _p, p_o, p_lse = fa.flash_attn_fwd_plain(q, k, v, True, 0, scale=scale)
    p_grads = fa.flash_attn_bwd_plain(q, k, v, p_o, p_lse, dout, True, 0,
                                      scale=scale)
    gaps = [_rel(o, p_o), _rel(lse, p_lse)] + [
        _rel(a, w) for a, w in zip(grads, p_grads)]
    assert max(gaps) <= 1e-5, gaps
    _out, o_default, _lse = fa.flash_attn_fwd(q, k, v, True, 0)
    assert _rel(o_default, p_o) > 1e-3
