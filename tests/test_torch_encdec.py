"""The port's enc-dec family (``repro_torch.models.encdec``, whisper-medium)
against the JAX package on the CPU: the same numpy inputs and params
(carried across by ``convert.tree_from_numpy``) through both, f32
compute at ``reduced()``.

Tolerances (ROADMAP): rtol 1e-5 / atol 1e-6 for one op (layernorm, the
tanh-GELU MLP); rtol 1e-4 / atol 1e-5 for model outputs (loss, every
gradient, the encoder's output, prefill and decode logits and caches)
and for trajectories.  Held here:

* the params tree, key for key and shape for shape, reduced and at full
  width (the port's on ``meta``, the reference's ``eval_shape``);
* ``encode``, ``train_loss`` and every gradient with and without remat,
  at the reduced encoder length (one attention chunk) and at three
  chunks with the decoder's queries shorter than the encoder's keys, as
  whisper's 448 text positions attend 1,536 frames in 512-key chunks;
* prefill and decode: logits, the self and cross caches, ``len``; the
  decode position table clamped at row 8,191 as the reference's
  ``dynamic_slice`` clamps it; decode against a prefill of the longer
  prefix;
* ``cs_adam`` on ``xla`` (B3's plain version on the CPU) for 30 steps
  against the JAX step; ``plan.cli --arch`` JSON; ``make_serve_step``'s
  cache and param specs; the launcher's ``[train]`` line.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as H
from repro import configs as jconfigs
from repro.models import common as JC
from repro.models import encdec as JE
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import common as TC
from repro_torch.models import encdec as TE
from repro_torch.train import steps as TS

ARCH = "whisper_medium"
CPU = H.CPU


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return (jconfigs.get(ARCH).reduced(**over),
            tconfigs.get(ARCH).reduced(**over))


def _params(cfg_j, seed=0):
    pj = jax.device_get(JE.init(jax.random.PRNGKey(seed), cfg_j))
    return pj, convert.tree_from_numpy(pj, CPU)


def _batch(cfg, b=2, s=32, seed=0, enc_seq=None):
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, cfg.vocab, (b, s)).astype(np.int32)
    frames = rs.standard_normal((b, enc_seq or cfg.enc_seq, cfg.d_model))
    return {"frames": frames.astype(np.float32), "tokens": tok,
            "labels": np.roll(tok, -1, axis=1)}


# ------------------------------------------------------------- params
@pytest.mark.parametrize("full", [False, True])
def test_params_tree_matches_reference(full):
    cfg_j, cfg_t = ((jconfigs.get(ARCH), tconfigs.get(ARCH)) if full
                    else _cfgs())
    want = H.shapes(jax.eval_shape(lambda: JE.init(jax.random.PRNGKey(0),
                                                   cfg_j)))
    tree = TE.init(None, cfg_t, device="meta")
    assert all(x.device.type == "meta" for _, x in leaf_paths(tree))
    assert H.shapes(tree) == want
    assert want["enc_layers/attn/wq"][0] == cfg_t.enc_layers
    assert want["dec_layers/cross_attn/wk"] == (
        cfg_t.n_layers, cfg_t.d_model, cfg_t.n_heads * cfg_t.head_dim)
    if full:
        n = sum(x.numel() for _, x in leaf_paths(tree))
        assert n == 811_323_392
    p = TE.init(torch.Generator().manual_seed(0), cfg_t)
    assert all(x.dtype == torch.float32 for _, x in leaf_paths(p))
    assert torch.equal(p["enc_norm"]["bias"], torch.zeros(cfg_t.d_model))
    assert abs(float(p["lm_head"]["table"].std()) - 0.02) < 0.002


# ----------------------------------------------------------------- ops
def test_layernorm_and_the_tanh_gelu_mlp_match_reference():
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 5, 64)).astype(np.float32)
    ln = {"scale": (1 + 0.1 * rs.standard_normal(64)).astype(np.float32),
          "bias": (0.1 * rs.standard_normal(64)).astype(np.float32)}
    H.close(TE._ln(H.t(x), {k: H.t(v) for k, v in ln.items()}),
            JE._ln(x, ln), H.OP)
    mlp = {"w1": (rs.standard_normal((64, 96)) / 8).astype(np.float32),
           "w2": (rs.standard_normal((96, 64)) / 10).astype(np.float32)}
    got = TE._mlp({k: H.t(v) for k, v in mlp.items()}, H.t(x))
    want = JE._mlp(mlp, x)
    H.close(got, want, H.OP)
    # the erf GELU misses the reference (jax.nn.gelu's default is tanh)
    erf = torch.nn.functional.gelu(H.t(x) @ H.t(mlp["w1"])) @ H.t(mlp["w2"])
    assert float((erf - H.t(want)).abs().max()) > 100 * H.OP["atol"]
    H.close(TC.sinusoidal_positions(20, 64, CPU),
            JC.sinusoidal_positions(20, 64), H.OP)


# --------------------------------------------------------------- model
@pytest.mark.parametrize("enc_seq", [16, 48])
def test_encode_matches_reference(enc_seq):
    cfg_j, cfg_t = _cfgs(enc_seq=enc_seq)
    pj, pt = _params(cfg_j, seed=1)
    frames = _batch(cfg_j, seed=1)["frames"]
    with torch.no_grad():
        got = TE.encode(cfg_t, pt, H.t(frames))
    H.close(got, JE.encode(cfg_j, pj, frames))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("enc_seq", [16, 48])
def test_train_loss_and_every_gradient_match_reference(remat, enc_seq):
    cfg_j, cfg_t = _cfgs(enc_seq=enc_seq)
    pj, _ = _params(cfg_j)
    grads = H.grads_match(JE, TE, cfg_j, cfg_t, pj, _batch(cfg_j),
                          remat=remat)
    # the frames reach the loss only through the cross-attention's K/V
    assert float(grads["dec_layers/cross_attn/wk"].abs().sum()) > 0
    assert float(grads["enc_layers/attn/wq"].abs().sum()) > 0


def test_sampled_softmax_train_loss_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=3)
    batch = _batch(cfg_j, seed=3)
    batch["neg_ids"] = np.random.RandomState(5).randint(
        0, cfg_j.vocab, 64).astype(np.int32)
    with torch.no_grad():
        got = TE.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()},
                            sampled_softmax=True)
    H.close(got, JE.train_loss(cfg_j, pj, batch, sampled_softmax=True))


def test_prefill_and_decode_match_reference():
    cfg_j, cfg_t = _cfgs(enc_seq=48)
    pj, pt = _params(cfg_j, seed=2)
    batch = _batch(cfg_j, s=20, seed=2)
    jlog, jc = JE.prefill(cfg_j, pj, batch["frames"], batch["tokens"], 32)
    with torch.no_grad():
        tlog, tc = TE.prefill(cfg_t, pt, H.t(batch["frames"]),
                              H.t(batch["tokens"]), 32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["ck"].shape == (cfg_t.n_layers, 2, 48, cfg_t.n_heads,
                              cfg_t.head_dim)
    for _ in range(4):
        H.close(tlog, jlog)
        for k in ("k", "v", "ck", "cv"):
            H.close(tc[k], jc[k], H.MODEL, k)
        assert int(tc["len"]) == int(jc["len"])
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jc = JE.decode_step(cfg_j, pj, jc, jnp.asarray(nxt))
        with torch.no_grad():
            tlog, tc = TE.decode_step(cfg_t, pt, tc, H.t(nxt))
    assert int(tc["len"]) == 24


def test_decode_position_clamps_at_the_table_end(monkeypatch):
    """Decode adds row ``pos`` of the 8,192-row table, clamped to its last
    row as the reference's ``dynamic_slice`` clamps it; a row equals the
    row prefill adds at that position.  Decode at position 8,195 is held
    to the reference's with the port given the reference's table: the
    two packages' f32 ``exp`` of the frequencies differ by an ulp here
    and there, which moves a row by up to 4.9e-4 at position 8,191
    (1.2e-4 within whisper's 1,536 frames; measured on the CPU)."""
    cfg_j, cfg_t = _cfgs()
    d = cfg_t.d_model
    assert torch.equal(TE._position_row(5, d, CPU),
                       TC.sinusoidal_positions(20, d, CPU)[5])
    assert torch.equal(TE._position_row(9000, d, CPU),
                       TE._position_row(8191, d, CPU))
    monkeypatch.setitem(TE._POSITIONS, (d, CPU),
                        H.t(JC.sinusoidal_positions(8192, d)))
    pj, pt = _params(cfg_j, seed=4)
    batch = _batch(cfg_j, b=1, s=4, seed=4)
    jlog, jc = JE.prefill(cfg_j, pj, batch["frames"], batch["tokens"], 8200)
    with torch.no_grad():
        tlog, tc = TE.prefill(cfg_t, pt, H.t(batch["frames"]),
                              H.t(batch["tokens"]), 8200)
    jc = dict(jc, len=jnp.asarray(8195, jnp.int32))
    tc = dict(tc, len=torch.tensor(8195, dtype=torch.int32))
    nxt = np.asarray([3], np.int32)
    jlog, _ = JE.decode_step(cfg_j, pj, jc, jnp.asarray(nxt))
    with torch.no_grad():
        tlog, _ = TE.decode_step(cfg_t, pt, tc, H.t(nxt))
    H.close(tlog, jlog)


def test_decode_agrees_with_prefill_of_the_prefix():
    _, cfg_t = _cfgs(enc_seq=48)
    gen = torch.Generator().manual_seed(3)
    p = TE.init(gen, cfg_t)
    frames = torch.randn((2, 48, cfg_t.d_model), generator=gen)
    tok = torch.randint(1, cfg_t.vocab, (2, 12), generator=gen,
                        dtype=torch.int32)
    with torch.no_grad():
        logits, cache = TE.prefill(cfg_t, p, frames, tok, 20)
        seq = tok
        for _ in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = TE.decode_step(cfg_t, p, cache, nxt)
            want, _ = TE.prefill(cfg_t, p, frames, seq)
            H.close(logits, want.numpy())


# --------------------------------------------------------- entry points
def test_cs_adam_trajectory_on_xla_matches_reference(monkeypatch):
    """30 steps at vocab 2,048 (both tables clear ``min_rows`` 1,024 and
    are sketched: B3's plain version, M and V)."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    batches = [_batch(cfg_j, seed=10 + i) for i in range(30)]
    state = H.trajectory(JE, JS, TS, cfg_j, cfg_t, batches, monkeypatch)
    for moment in ("m", "v"):
        leaf = dict(leaf_paths(state[moment]))
        assert leaf["tok_embed/table"].numel() < 2048 * cfg_t.d_model
        assert leaf["lm_head/table"].numel() < 2048 * cfg_t.d_model
    assert int(state["step"]) == 30


def test_plan_cli_matches_the_reference(tmp_path, capsys):
    from repro.plan import cli as JCLI
    from repro_torch.plan import cli as TCLI
    argv = ["--arch", ARCH, "--budgets", "floor,0.9x,1.0x", "--check"]
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
    """``ServeStep.cache_specs`` counts ``enc_seq`` as a sequence dim: the
    cross cache's 1,536 frames go over 'model', as the reference's."""
    m = H.mesh(shape, names)
    want, got = H.serve_specs(monkeypatch, jconfigs.get(ARCH),
                              tconfigs.get(ARCH), m)
    assert got == want
    cache_specs = got[0]
    if shape[-1] > 1:
        assert cache_specs["ck"][2] == "model"


def test_launcher_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                                capsys):
    (jline, jloss), (tline, tloss) = H.launcher_lines(
        tmp_path, monkeypatch, capsys, ["--arch", ARCH, "--reduced",
                                        "--batch", "2", "--seq", "32"])
    assert tline.startswith("[train] arch=whisper-medium-smoke "
                            "optimizer=cs_adam dp=False steps=3 loss ")
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-3)


def test_make_serve_step_reads_the_frames():
    cfg = tconfigs.get(ARCH).reduced()
    from repro_torch.serve import make_serve_step
    ss = make_serve_step(cfg, batch=2, max_seq=40)
    p = TE.init(torch.Generator().manual_seed(0), cfg)
    b = _batch(cfg, s=8)
    logits, cache = ss.prefill_fn(p, {"frames": H.t(b["frames"]),
                                      "tokens": H.t(b["tokens"])})
    assert logits.shape == (2, cfg.vocab) and not logits.requires_grad
    shape = {k: tuple(v.shape) for k, v in ss.cache_shape().items()}
    assert shape == {k: tuple(v.shape) for k, v in cache.items()}
    assert dataclasses.replace(cfg).family == "encdec"
