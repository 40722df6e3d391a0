"""The port's RWKV6 family (``repro_torch.models.rwkv``, rwkv6-7b) against
the JAX package on the CPU: the same numpy inputs and params (carried
across by ``convert.tree_from_numpy``) through both, f32 compute at
``reduced()`` (``rwkv_chunk`` 4).

Tolerances (ROADMAP): rtol 1e-5 / atol 1e-6 for one op (``wkv_scan``,
``wkv_chunked``, ``wkv_step``); rtol 1e-4 / atol 1e-5 for model outputs
(``time_mix``, ``channel_mix``, loss, every gradient, prefill and decode
logits and every state leaf) and for trajectories.  Held here:

* the params tree, key for key and shape for shape, reduced and at full
  width (the port's on ``meta``, the reference's ``eval_shape``);
* ``convert``'s round trips of the params (the ``u`` (h, hd) leaves
  included) and of a ``cs_adam`` train state, bit for bit;
* the wkv core at a length that divides the chunk (the chunked form)
  and at one that does not (its fall back to the scan), from a non-zero
  state;
* ``train_loss`` and every gradient with and without remat, on both
  routes; the sampled softmax;
* prefill and decode: logits and every state leaf, ``len`` through
  ``make_serve_step``; decode against the prefill of the longer prefix;
* bf16 compute (``reduced(compute_dtype="bfloat16")``): loss and prefill
  logits and state within the bf16 tolerances of ``torch_lm_parity``;
* ``cs_adam`` on ``xla`` (B3's plain version on the CPU) for 30 steps
  against the JAX step; ``plan.cli --arch`` JSON; ``make_serve_step``'s
  cache and param specs.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as H
from repro import configs as jconfigs
from repro.models import rwkv as JR
from repro.serve import steps as JSS
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import rwkv as TR
from repro_torch.serve import make_serve_step
from repro_torch.train import steps as TS

ARCH = "rwkv6_7b"
CPU = H.CPU
BF16_LOSS, BF16_SCALE = H.BF16_LOSS, H.BF16_SCALE


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return (jconfigs.get(ARCH).reduced(**over),
            tconfigs.get(ARCH).reduced(**over))


def _params(cfg_j, seed=0):
    pj = jax.device_get(JR.init(jax.random.PRNGKey(seed), cfg_j))
    return pj, convert.tree_from_numpy(pj, CPU)


def _batch(cfg, b=2, s=16, seed=0):
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def _wkv_inputs(seed, b=2, s=8, h=3, K=4, V=5):
    rs = np.random.RandomState(seed)
    r, k = (rs.standard_normal((b, s, h, K)).astype(np.float32)
            for _ in range(2))
    v = rs.standard_normal((b, s, h, V)).astype(np.float32)
    logw = -rs.uniform(1e-3, TR.LOG_DECAY_CLIP, (b, s, h, K)).astype(
        np.float32)
    u = (0.1 * rs.standard_normal((h, K))).astype(np.float32)
    S0 = rs.standard_normal((b, h, K, V)).astype(np.float32)
    return r, k, v, logw, u, S0


# ------------------------------------------------------------- params
@pytest.mark.parametrize("full", [False, True])
def test_params_tree_matches_reference(full):
    cfg_j, cfg_t = ((jconfigs.get(ARCH), tconfigs.get(ARCH)) if full
                    else _cfgs())
    want = H.shapes(jax.eval_shape(lambda: JR.init(jax.random.PRNGKey(0),
                                                   cfg_j)))
    tree = TR.init(None, cfg_t, device="meta")
    assert all(x.device.type == "meta" for _, x in leaf_paths(tree))
    assert H.shapes(tree) == want
    h, hd, d = cfg_t.rwkv_heads, cfg_t.rwkv_head_dim, cfg_t.d_model
    assert want["layers/tm/u"] == (cfg_t.n_layers, h, hd)
    assert want["layers/tm/w_A"] == (cfg_t.n_layers, d, max(32, d // 64))
    if full:
        n = sum(x.numel() for _, x in leaf_paths(tree))
        assert n == 7_534_546_944
        assert want["layers/tm/w_A"][2] == 64
        return
    p = TR.init(torch.Generator().manual_seed(0), cfg_t)
    assert all(x.dtype == torch.float32 for _, x in leaf_paths(p))
    assert torch.equal(p["layers"]["tm"]["w_base"],
                       torch.full((cfg_t.n_layers, d), -2.0))
    assert abs(float(p["layers"]["tm"]["u"].std()) - 0.1) < 0.02


def test_convert_round_trips_the_params_and_a_train_state():
    """``tree_from_numpy`` / ``tree_to_numpy`` and ``train_state_from_numpy``
    / ``train_state_to_numpy`` carry the whole tree (layers/tm/u among its
    leaves) and a ``cs_adam`` state, bit for bit."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    pj = jax.device_get(JR.init(jax.random.PRNGKey(7), cfg_j))
    sj = jax.device_get(JS.build_optimizer(cfg_j, "cs_adam").init(pj))
    back = convert.tree_to_numpy(convert.tree_from_numpy(pj, CPU))
    assert "layers/tm/u" in H.flat(back)
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
def test_wkv_core_matches_reference(s):
    """At s = 8 (two chunks of 4) the chunked form; at s = 10 it falls
    back to the scan.  The state starts non-zero."""
    ins = _wkv_inputs(1, s=s)
    tins = [H.t(a) for a in ins]
    jo, jS = JR.wkv_scan(*ins)
    to, tS = TR.wkv_scan(*tins)
    H.close(to, jo, H.OP)
    H.close(tS, jS, H.OP)
    jo, jS = JR.wkv_chunked(*ins, chunk=4)
    to, tS = TR.wkv_chunked(*tins, chunk=4)
    H.close(to, jo, H.OP)
    H.close(tS, jS, H.OP)
    # the chunked form is the scan's recurrence
    so, sS = TR.wkv_scan(*tins)
    H.close(to, so.numpy(), H.OP)
    H.close(tS, sS.numpy(), H.OP)
    r, k, v, logw, u, S0 = ins
    jo, jS = JR.wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, S0)
    to, tS = TR.wkv_step(*(x[:, 0] for x in tins[:4]), tins[4], tins[5])
    H.close(to, jo, H.OP)
    H.close(tS, jS, H.OP)


@pytest.mark.parametrize("mode,s", [("chunked", 8), ("scan", 8),
                                    ("chunked", 6)])
def test_time_mix_and_channel_mix_match_reference(mode, s):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=1)
    lj = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    lt = jax.tree_util.tree_map(lambda a: a[0], pt["layers"])
    rs = np.random.RandomState(2)
    b, d = 2, cfg_t.d_model
    x = rs.standard_normal((b, s, d)).astype(np.float32)
    prev = rs.standard_normal((b, d)).astype(np.float32)
    S0 = rs.standard_normal((b, cfg_t.rwkv_heads, cfg_t.rwkv_head_dim,
                             cfg_t.rwkv_head_dim)).astype(np.float32)
    jo, jx, jS = JR.time_mix(cfg_j, lj["tm"], x, prev, S0, mode)
    with torch.no_grad():
        to, tx, tS = TR.time_mix(cfg_t, lt["tm"], H.t(x), H.t(prev),
                                 H.t(S0), mode)
    H.close(to, jo)
    H.close(tx, jx)
    H.close(tS, jS)
    jo, jx = JR.channel_mix(cfg_j, lj["cm"], x, prev)
    with torch.no_grad():
        to, tx = TR.channel_mix(cfg_t, lt["cm"], H.t(x), H.t(prev))
    H.close(to, jo)
    H.close(tx, jx)


# --------------------------------------------------------------- model
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("s", [16, 18])
def test_train_loss_and_every_gradient_match_reference(remat, s):
    """s = 16 runs the chunked form, s = 18 the scan."""
    cfg_j, cfg_t = _cfgs()
    pj, _ = _params(cfg_j)
    grads = H.grads_match(JR, TR, cfg_j, cfg_t, pj, _batch(cfg_j, s=s),
                          remat=remat)
    for path in ("layers/tm/u", "layers/tm/w_A", "layers/tm/w_base",
                 "layers/cm/wv", "tok_embed/table"):
        assert float(grads[path].abs().sum()) > 0, path


def test_sampled_softmax_train_loss_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=3)
    batch = _batch(cfg_j, seed=3)
    batch["neg_ids"] = np.random.RandomState(5).randint(
        0, cfg_j.vocab, 64).astype(np.int32)
    with torch.no_grad():
        got = TR.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()},
                            sampled_softmax=True)
    H.close(got, JR.train_loss(cfg_j, pj, batch, sampled_softmax=True))


def test_prefill_and_decode_match_reference():
    """Through both packages' ``make_serve_step``: logits and every cache
    leaf, ``len`` included, after a prefill of 12 (chunked) and each of
    4 decode steps."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=2)
    tok = _batch(cfg_j, s=12, seed=2)["tokens"]
    js = JSS.make_serve_step(cfg_j, batch=2, max_seq=20)
    ts = make_serve_step(cfg_t, batch=2, max_seq=20)
    jlog, jc = js.prefill_fn(pj, {"tokens": tok})
    tlog, tc = ts.prefill_fn(pt, {"tokens": H.t(tok)})
    assert sorted(tc) == sorted(jc) == ["S", "cm_x", "len", "tm_x"]
    for _ in range(4):
        H.close(tlog, jlog)
        for k in ("S", "cm_x", "tm_x"):
            assert tc[k].dtype == torch.float32
            H.close(tc[k], jc[k], H.MODEL, k)
        assert int(tc["len"]) == int(jc["len"])
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
        logits, state = TR.prefill(cfg_t, pt, H.t(tok))
        seq = H.t(tok)
        for _ in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, state = TR.decode_step(cfg_t, pt, state, nxt)
            want, _ = TR.prefill(cfg_t, pt, seq)
            H.close(logits, want.numpy())
            jwant, _ = JR.prefill(cfg_j, pj, seq.numpy())
            H.close(logits, jwant)


def test_bf16_compute_matches_reference():
    """``reduced(compute_dtype="bfloat16")``: loss and prefill logits
    within the bf16 tolerances stated above; the state stays f32."""
    cfg_j, cfg_t = _cfgs(compute_dtype="bfloat16")
    pj, pt = _params(cfg_j, seed=6)
    batch = _batch(cfg_j, seed=6)
    with torch.no_grad():
        tl = TR.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()})
        tlog, tst = TR.prefill(cfg_t, pt, H.t(batch["tokens"]))
    H.close(tl, JR.train_loss(cfg_j, pj, batch), BF16_LOSS)
    jlog, jst = JR.prefill(cfg_j, pj, batch["tokens"])
    assert tlog.dtype == torch.bfloat16
    H.within_scale(tlog, jlog, BF16_SCALE, axis=-1)
    assert all(v.dtype == torch.float32 for v in tst.values())
    for k in jst:
        H.within_scale(tst[k], jst[k], BF16_SCALE)


# --------------------------------------------------------- entry points
def test_cs_adam_trajectory_on_xla_matches_reference(monkeypatch):
    """30 steps at vocab 2,048 (both tables clear ``min_rows`` 1,024 and
    are sketched: B3's plain version, M and V)."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    batches = [_batch(cfg_j, seed=10 + i) for i in range(30)]
    state = H.trajectory(JR, JS, TS, cfg_j, cfg_t, batches, monkeypatch)
    for moment in ("m", "v"):
        leaf = dict(leaf_paths(state[moment]))
        assert leaf["tok_embed/table"].numel() < 2048 * cfg_t.d_model
        assert leaf["lm_head/table"].numel() < 2048 * cfg_t.d_model
        assert leaf["layers/tm/u"].shape == (cfg_t.n_layers,
                                             cfg_t.rwkv_heads,
                                             cfg_t.rwkv_head_dim)
    assert int(state["step"]) == 30


def test_plan_cli_matches_the_reference(tmp_path, capsys):
    """rwkv6-7b's plans at its 57 GB config budget, its floor and dense:
    the JSON and the printed tables equal the reference's."""
    from repro.plan import cli as JCLI
    from repro_torch.plan import cli as TCLI
    argv = ["--arch", ARCH, "--budgets", "floor,config,1.0x", "--check"]
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
    """The recurrent state has no sequence dim: its heads go over
    'model', as the reference's."""
    m = H.mesh(shape, names)
    want, got = H.serve_specs(monkeypatch, jconfigs.get(ARCH),
                              tconfigs.get(ARCH), m)
    assert got == want
    if shape[-1] > 1:
        assert got[0]["S"][2] == "model"


def test_make_serve_step_cache_matches_reference():
    """``cache_factory`` and ``ServeStep.cache_shape``: the reference's
    leaves, shapes and dtypes; prefill fills the same tree."""
    cfg_j, cfg_t = _cfgs()
    ss = make_serve_step(cfg_t, batch=2, max_seq=40)
    want = H.shapes(JSS.make_serve_step(cfg_j, batch=2,
                                        max_seq=40).cache_shape())
    shape = ss.cache_shape()
    assert H.shapes(shape) == want
    # the state on meta; ``len`` a host int32 scalar, as every family's
    assert all(x.device.type == "meta" for k, x in shape.items()
               if k != "len")
    assert shape["len"].dtype == torch.int32 and shape["len"].dim() == 0
    p = TR.init(torch.Generator().manual_seed(0), cfg_t)
    logits, cache = ss.prefill_fn(p, {"tokens": H.t(_batch(cfg_t, s=8)[
        "tokens"])})
    assert logits.shape == (2, cfg_t.vocab) and not logits.requires_grad
    assert H.shapes(cache) == want and int(cache["len"]) == 8
