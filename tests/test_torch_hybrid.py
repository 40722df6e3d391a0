"""The port's hybrid family (``repro_torch.models.mamba``, zamba2-2.7b:
Mamba2 layers and one weight-shared attention block every
``attn_every``) against the JAX package on the CPU: the same numpy
inputs and params (carried across by ``convert.tree_from_numpy``)
through both, f32 compute at ``reduced()`` (4 layers, 2 attention
sites, ``rwkv_chunk`` 4).

Tolerances (ROADMAP): rtol 1e-5 / atol 1e-6 for one op (``ssd_scan``,
``ssd_chunked``, ``_causal_conv``); rtol 1e-4 / atol 1e-5 for model
outputs (``mamba_apply``, loss, every gradient, prefill and decode
logits and every cache leaf) and for trajectories.  Held here:

* the params tree, key for key and shape for shape, reduced and at full
  width (the port's on ``meta``, the reference's ``eval_shape``),
  ``shared_attn`` included;
* ``convert``'s round trips of the params (``shared_attn`` included) and of a
  ``cs_adam`` train state, bit for bit;
* the SSD core at a length that divides the chunk and at one that does
  not, from a non-zero state; in bf16 the chunked form rounds the decay
  matrix and the state update's weights where the reference does (an
  unrounded form misses it by 100x the op tolerance); past the f32
  overflow of the exp above the diagonal, where the reference's gradient
  is NaN, the port's equals the reference's scan's; the causal conv with
  a non-zero carry;
* ``mamba_apply`` on both routes, ``train_loss`` and every gradient with
  and without remat; the sampled softmax;
* prefill and decode: logits and every cache leaf (the mamba state, each
  site's KV cache, ``len``); decode against the prefill of the longer
  prefix;
* bf16 compute (``reduced(compute_dtype="bfloat16")``) within the bf16
  tolerances of ``torch_lm_parity``;
* ``cs_adam`` on ``xla`` for 30 steps against the JAX step;
  ``plan.cli --arch`` JSON; ``make_serve_step``'s cache and specs.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_lm_parity as H
from repro import configs as jconfigs
from repro.models import mamba as JM
from repro.serve import steps as JSS
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import mamba as TM
from repro_torch.serve import make_serve_step
from repro_torch.train import steps as TS

ARCH = "zamba2_2_7b"
CPU = H.CPU
BF16_LOSS, BF16_SCALE = H.BF16_LOSS, H.BF16_SCALE


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return (jconfigs.get(ARCH).reduced(**over),
            tconfigs.get(ARCH).reduced(**over))


def _params(cfg_j, seed=0):
    pj = jax.device_get(JM.init(jax.random.PRNGKey(seed), cfg_j))
    return pj, convert.tree_from_numpy(pj, CPU)


def _batch(cfg, b=2, s=16, seed=0):
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def _t(a) -> torch.Tensor:
    """A tensor copy of a numpy array (bf16 bit for bit)."""
    return convert._leaf_from_numpy(np.array(a), CPU)


def _ssd_inputs(seed, dtype=np.float32, b=2, s=8, h=3, p=8, n=6):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, s, h, p)).astype(dtype)
    B, C = (rs.standard_normal((b, s, n)).astype(dtype) for _ in range(2))
    dt = rs.uniform(0.1, 1.0, (b, s, h)).astype(np.float32)
    la = -rs.uniform(0.1, 2.0, (b, s, h)).astype(np.float32)
    h0 = rs.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, la, B, C, h0


# ------------------------------------------------------------- params
@pytest.mark.parametrize("full", [False, True])
def test_params_tree_matches_reference(full):
    cfg_j, cfg_t = ((jconfigs.get(ARCH), tconfigs.get(ARCH)) if full
                    else _cfgs())
    want = H.shapes(jax.eval_shape(lambda: JM.init(jax.random.PRNGKey(0),
                                                   cfg_j)))
    tree = TM.init(None, cfg_t, device="meta")
    assert all(x.device.type == "meta" for _, x in leaf_paths(tree))
    assert H.shapes(tree) == want
    hd = cfg_t.d_model // cfg_t.n_heads
    assert want["shared_attn/attn/wq"] == (cfg_t.d_model,
                                           cfg_t.n_heads * hd)
    assert want["layers/conv_w_x"] == (cfg_t.n_layers, cfg_t.conv_kernel,
                                       cfg_t.ssm_d_inner)
    if full:
        n = sum(x.numel() for _, x in leaf_paths(tree))
        assert n == 2_422_670_240 and hd == 80
        assert TM.n_attn_sites(cfg_t) == 9
        return
    p = TM.init(torch.Generator().manual_seed(0), cfg_t)
    assert all(x.dtype == torch.float32 for _, x in leaf_paths(p))
    assert torch.equal(p["layers"]["D"],
                       torch.ones((cfg_t.n_layers, cfg_t.ssm_heads)))
    assert abs(float(p["layers"]["conv_w_x"].std()) - 0.2) < 0.02


def test_convert_round_trips_the_params_and_a_train_state():
    """``tree_from_numpy`` / ``tree_to_numpy`` and ``train_state_from_numpy``
    / ``train_state_to_numpy`` carry the whole tree (shared_attn/attn/wq among its
    leaves) and a ``cs_adam`` state, bit for bit."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    pj = jax.device_get(JM.init(jax.random.PRNGKey(7), cfg_j))
    sj = jax.device_get(JS.build_optimizer(cfg_j, "cs_adam").init(pj))
    back = convert.tree_to_numpy(convert.tree_from_numpy(pj, CPU))
    assert "shared_attn/attn/wq" in H.flat(back)
    assert H.shapes(back) == H.shapes(pj)
    for path, want in leaf_paths(pj):
        assert np.array_equal(dict(leaf_paths(back))[path], want), path
    ts = convert.train_state_from_numpy(5, pj, sj, CPU)
    step, p2, s2 = convert.train_state_to_numpy(ts)
    assert step == 5
    for tree, want in ((p2, pj), (s2, sj)):
        got = dict(leaf_paths(tree))
        assert sorted(got) == sorted(p for p, _ in leaf_paths(want))
        for path, leaf in leaf_paths(want):
            assert np.array_equal(np.asarray(got[path]), np.asarray(leaf)), \
                path


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("s", [8, 10])
def test_ssd_core_matches_reference(s):
    """At s = 8 (two chunks of 4) the chunked form; at s = 10 it falls
    back to the scan.  The state starts non-zero."""
    ins = _ssd_inputs(1, s=s)
    tins = [_t(a) for a in ins]
    jy, jh = JM.ssd_scan(*ins)
    ty, th = TM.ssd_scan(*tins)
    H.close(ty, jy, H.OP)
    H.close(th, jh, H.OP)
    jy, jh = JM.ssd_chunked(*ins, chunk=4)
    ty, th = TM.ssd_chunked(*tins, chunk=4)
    H.close(ty, jy, H.OP)
    H.close(th, jh, H.OP)
    sy, sh = TM.ssd_scan(*tins)
    H.close(ty, sy.numpy(), H.OP)
    H.close(th, sh.numpy(), H.OP)


def test_ssd_chunked_rounds_where_the_reference_does():
    """bf16 x, B and C: the decay matrix M and the weights w are rounded
    to bf16 before their products, which are exact in f32 and summed in
    f32; y and the state within the op tolerance.  Left unrounded (the
    same values given as f32) the form misses the reference by more than
    100x that tolerance."""
    ins = _ssd_inputs(2, dtype=ml_dtypes.bfloat16, s=16)
    tins = [_t(a) for a in ins]
    assert tins[0].dtype == torch.bfloat16
    jy, jh = JM.ssd_chunked(*ins, chunk=4)
    ty, th = TM.ssd_chunked(*tins, chunk=4)
    assert ty.dtype == th.dtype == torch.float32
    H.close(ty, jy, H.OP)
    H.close(th, jh, H.OP)
    up = [t.float() for t in tins]
    uy, _ = TM.ssd_chunked(*up, chunk=4)
    miss = np.abs(uy.numpy() - np.asarray(jy)) - (
        H.OP["atol"] + H.OP["rtol"] * np.abs(np.asarray(jy)))
    assert float(miss.max()) > 100 * H.OP["atol"]


def test_ssd_chunked_gradient_past_the_exp_overflow():
    """One chunk of 8 whose log-decays sum to -105 above the diagonal: the
    reference's exp overflows there before its mask, and its gradient is
    NaN; the port zeroes those exponents first.  Its forward equals the
    reference's, and its gradient is finite and equals the reference's
    scan (whose decays are each at most 1)."""
    x, dt, la, B, C, h0 = _ssd_inputs(5, s=8)
    la = np.full_like(la, -15.0)

    def jloss(fn, la_):
        y, h = fn(x, dt, la_, B, C, h0)
        return jnp.sum(y) + jnp.sum(h)

    jg = jax.grad(lambda a: jloss(lambda *z: JM.ssd_chunked(*z, chunk=8),
                                  a))(la)
    assert np.isnan(np.asarray(jg)).any()
    jscan = jax.grad(lambda a: jloss(JM.ssd_scan, a))(la)
    assert np.isfinite(np.asarray(jscan)).all()
    tla = _t(la).requires_grad_(True)
    ty, th = TM.ssd_chunked(_t(x), _t(dt), tla, _t(B), _t(C), _t(h0), 8)
    jy, jh = JM.ssd_chunked(x, dt, la, B, C, h0, 8)
    H.close(ty.detach(), jy, H.OP)
    H.close(th.detach(), jh, H.OP)
    (ty.sum() + th.sum()).backward()
    assert torch.isfinite(tla.grad).all()
    H.close(tla.grad, jscan, H.MODEL)


def test_causal_conv_with_a_carry_matches_reference():
    rs = np.random.RandomState(3)
    for s in (7, 1):
        x = rs.standard_normal((2, s, 10)).astype(np.float32)
        w = (0.2 * rs.standard_normal((4, 10))).astype(np.float32)
        b = (0.1 * rs.standard_normal(10)).astype(np.float32)
        prev = rs.standard_normal((2, 3, 10)).astype(np.float32)
        jy, jp = JM._causal_conv(x, w, b, prev)
        ty, tp = TM._causal_conv(_t(x), _t(w), _t(b), _t(prev))
        H.close(ty, jy, H.OP)
        assert tp.dtype == torch.float32
        H.close(tp, jp, H.OP)
    # the carry is the last K-1 inputs (the previous carry when s < K-1)
    assert torch.equal(tp[:, :2], _t(prev)[:, 1:])


@pytest.mark.parametrize("mode,s", [("chunked", 8), ("scan", 8),
                                    ("chunked", 6)])
def test_mamba_apply_matches_reference(mode, s):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=1)
    lj = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    lt = jax.tree_util.tree_map(lambda a: a[0], pt["layers"])
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    st = {k: rs.standard_normal(v.shape[1:]).astype(np.float32)
          for k, v in jax.device_get(JM.mamba_zero_state(cfg_j, 2, 1)).items()}
    jx, jst = JM.mamba_apply(cfg_j, lj, x, st, mode)
    with torch.no_grad():
        tx, tst = TM.mamba_apply(cfg_t, lt, _t(x),
                                 {k: _t(v) for k, v in st.items()}, mode)
    H.close(tx, jx)
    for k in jst:
        H.close(tst[k], jst[k], H.MODEL, k)


# --------------------------------------------------------------- model
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("s", [16, 18])
def test_train_loss_and_every_gradient_match_reference(remat, s):
    """s = 16 runs the chunked form, s = 18 the scan; the shared block's
    gradient sums its two sites'."""
    cfg_j, cfg_t = _cfgs()
    pj, _ = _params(cfg_j)
    grads = H.grads_match(JM, TM, cfg_j, cfg_t, pj, _batch(cfg_j, s=s),
                          remat=remat)
    for path in ("shared_attn/attn/wq", "shared_attn/ffn/w_up",
                 "layers/A_log", "layers/conv_w_bc", "layers/dt_bias"):
        assert float(grads[path].abs().sum()) > 0, path


def test_sampled_softmax_train_loss_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=3)
    batch = _batch(cfg_j, seed=3)
    batch["neg_ids"] = np.random.RandomState(5).randint(
        0, cfg_j.vocab, 64).astype(np.int32)
    with torch.no_grad():
        got = TM.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()},
                            sampled_softmax=True)
    H.close(got, JM.train_loss(cfg_j, pj, batch, sampled_softmax=True))


def _cache_close(tc, jc):
    assert H.shapes(tc) == H.shapes(jc)
    for k in ("attn_k", "attn_v"):
        H.close(tc[k], jc[k], H.MODEL, k)
    for k in jc["mamba"]:
        H.close(tc["mamba"][k], jc["mamba"][k], H.MODEL, k)
    assert int(tc["len"]) == int(jc["len"])


def test_prefill_and_decode_match_reference():
    """Through both packages' ``make_serve_step``: logits and every cache
    leaf after a prefill of 12 (chunked) and each of 4 decode steps."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=2)
    tok = _batch(cfg_j, s=12, seed=2)["tokens"]
    js = JSS.make_serve_step(cfg_j, batch=2, max_seq=20)
    ts = make_serve_step(cfg_t, batch=2, max_seq=20)
    jlog, jc = js.prefill_fn(pj, {"tokens": tok})
    tlog, tc = ts.prefill_fn(pt, {"tokens": H.t(tok)})
    assert tc["attn_k"].shape == (2, 2, 20, cfg_t.n_kv,
                                  cfg_t.d_model // cfg_t.n_heads)
    for _ in range(4):
        H.close(tlog, jlog)
        _cache_close(tc, jc)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jc = js.decode_fn(pj, jc, jnp.asarray(nxt))
        tlog, tc = ts.decode_fn(pt, tc, H.t(nxt))
    assert int(tc["len"]) == 16


def test_decode_agrees_with_prefill_of_the_prefix():
    """Each decoded token's logits equal a prefill of the prefix it
    extends (lengths 13..16: the scan, then the chunked form), in the
    port and in the reference."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=4)
    tok = _batch(cfg_j, s=12, seed=4)["tokens"]
    with torch.no_grad():
        logits, cache = TM.prefill(cfg_t, pt, H.t(tok), 16)
        seq = H.t(tok)
        for _ in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = TM.decode_step(cfg_t, pt, cache, nxt)
            want, _ = TM.prefill(cfg_t, pt, seq)
            H.close(logits, want.numpy())
            jwant, _ = JM.prefill(cfg_j, pj, seq.numpy())
            H.close(logits, jwant)


def test_bf16_compute_matches_reference():
    """``reduced(compute_dtype="bfloat16")``: loss, prefill logits and the
    cache within the bf16 tolerances of ``torch_lm_parity``; the KV
    caches in bf16, the mamba state in f32."""
    cfg_j, cfg_t = _cfgs(compute_dtype="bfloat16")
    pj, pt = _params(cfg_j, seed=6)
    batch = _batch(cfg_j, seed=6)
    with torch.no_grad():
        tl = TM.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()})
        tlog, tc = TM.prefill(cfg_t, pt, H.t(batch["tokens"]))
    H.close(tl, JM.train_loss(cfg_j, pj, batch), BF16_LOSS)
    jlog, jc = JM.prefill(cfg_j, pj, batch["tokens"])
    assert tlog.dtype == tc["attn_k"].dtype == torch.bfloat16
    H.within_scale(tlog, jlog, BF16_SCALE, axis=-1)
    for k in ("attn_k", "attn_v"):
        H.within_scale(tc[k], jc[k], BF16_SCALE)
    for k in jc["mamba"]:
        assert tc["mamba"][k].dtype == torch.float32
        H.within_scale(tc["mamba"][k], jc["mamba"][k], BF16_SCALE)


# --------------------------------------------------------- entry points
def test_cs_adam_trajectory_on_xla_matches_reference(monkeypatch):
    """30 steps at vocab 2,048 (both tables clear ``min_rows`` 1,024 and
    are sketched: B3's plain version, M and V)."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    batches = [_batch(cfg_j, seed=10 + i) for i in range(30)]
    state = H.trajectory(JM, JS, TS, cfg_j, cfg_t, batches, monkeypatch)
    for moment in ("m", "v"):
        leaf = dict(leaf_paths(state[moment]))
        assert leaf["tok_embed/table"].numel() < 2048 * cfg_t.d_model
        assert leaf["lm_head/table"].numel() < 2048 * cfg_t.d_model
        assert "shared_attn/attn/wq" in leaf
    assert int(state["step"]) == 30


def test_plan_cli_matches_the_reference(tmp_path, capsys):
    from repro.plan import cli as JCLI
    from repro_torch.plan import cli as TCLI
    argv = ["--arch", ARCH, "--budgets", "floor,0.95x,1.0x", "--check"]
    assert JCLI.main(argv + ["--json", str(tmp_path / "j.json")]) == 0
    jout = capsys.readouterr().out
    assert TCLI.main(argv + ["--json", str(tmp_path / "t.json")]) == 0
    tout = capsys.readouterr().out
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    keep = [l for l in jout.splitlines() if not l.startswith("[plan] wrote")]
    assert keep == [l for l in tout.splitlines()
                    if not l.startswith("[plan] wrote")]
    assert tout.count("[check] OK") == 3


@pytest.mark.parametrize("shape,names", [((1, 1), ("data", "model")),
                                         ((2, 4), ("data", "model")),
                                         ((2, 16, 16),
                                          ("pod", "data", "model"))])
def test_serve_step_specs_match_reference(monkeypatch, shape, names):
    """The KV caches' sequence dim goes over 'model', the mamba state's
    heads, as the reference's."""
    m = H.mesh(shape, names)
    want, got = H.serve_specs(monkeypatch, jconfigs.get(ARCH),
                              tconfigs.get(ARCH), m)
    assert got == want
    if shape[-1] > 1:
        assert got[0]["attn_k"][2] == "model"
        assert got[0]["mamba/h"][2] == "model"


def test_make_serve_step_cache_matches_reference():
    cfg_j, cfg_t = _cfgs()
    ss = make_serve_step(cfg_t, batch=2, max_seq=40)
    want = H.shapes(JSS.make_serve_step(cfg_j, batch=2,
                                        max_seq=40).cache_shape())
    shape = ss.cache_shape()
    assert H.shapes(shape) == want
    assert shape["attn_k"].device.type == "meta"
    assert shape["len"].dtype == torch.int32 and shape["len"].dim() == 0
    p = TM.init(torch.Generator().manual_seed(0), cfg_t)
    logits, cache = ss.prefill_fn(p, {"tokens": H.t(_batch(cfg_t, s=8)[
        "tokens"])})
    assert logits.shape == (2, cfg_t.vocab) and not logits.requires_grad
    assert H.shapes(cache) == want and int(cache["len"]) == 8
    assert not bool(cache["attn_k"][:, :, 8:].any())
