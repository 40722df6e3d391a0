"""The port's VLM family (``repro_torch.models.vlm``, internvl2-2b) against
the JAX package on the CPU: the same numpy patches, tokens and params
(carried across by ``convert.tree_from_numpy``) through both, f32
compute at ``reduced()``.

Tolerances (ROADMAP): rtol 1e-4 / atol 1e-5 for model outputs and
trajectories.  Held here:

* the params tree: the transformer's, key for key, reduced and at full
  width (the port's on ``meta``, the reference's ``eval_shape``);
* ``train_loss`` and every gradient with and without remat: [patches;
  text] at positions 0..P+s-1 (rope over the patches), the final norm
  and the loss over the text positions only, plus 0.01 × the aux term;
  at one attention chunk and across chunk boundaries; the sampled
  softmax;
* prefill (the transformer's cache of P + s positions, ``len`` P + s)
  and decode; decode against a prefill of the longer prefix;
* ``cs_adam`` on ``xla`` (B3's plain version on the CPU) for 30 steps
  against the JAX step; ``plan.cli --arch`` JSON; ``make_serve_step``'s
  cache and param specs; the launcher's ``[train]`` line;
* the launchers' zero stub patches: at 16 layers the gradient overflows
  to NaN in both packages alike.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as H
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models import vlm as JV
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import transformer as TT
from repro_torch.models import vlm as TV
from repro_torch.train import steps as TS

ARCH = "internvl2_2b"
CPU = H.CPU


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    return (jconfigs.get(ARCH).reduced(**over),
            tconfigs.get(ARCH).reduced(**over))


def _params(cfg_j, seed=0):
    pj = jax.device_get(JV.init(jax.random.PRNGKey(seed), cfg_j))
    return pj, convert.tree_from_numpy(pj, CPU)


def _batch(cfg, b=2, s=24, seed=0):
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, cfg.vocab, (b, s)).astype(np.int32)
    patches = rs.standard_normal((b, cfg.n_patches, cfg.d_model))
    return {"patches": patches.astype(np.float32), "tokens": tok,
            "labels": np.roll(tok, -1, axis=1)}


# ------------------------------------------------------------- params
@pytest.mark.parametrize("full", [False, True])
def test_params_tree_is_the_transformers(full):
    cfg_j, cfg_t = ((jconfigs.get(ARCH), tconfigs.get(ARCH)) if full
                    else _cfgs())
    want = H.shapes(jax.eval_shape(lambda: JV.init(jax.random.PRNGKey(0),
                                                   cfg_j)))
    tree = TV.init(None, cfg_t, device="meta")
    assert H.shapes(tree) == want == H.shapes(
        TT.init(None, cfg_t, device="meta"))
    assert TT.n_scan_units(cfg_t) == cfg_t.n_layers
    if full:
        assert sum(x.numel() for _, x in leaf_paths(tree)) == 1_889_634_304
        assert want["layers/attn/wk"] == (24, 2048, 8 * 128)


# --------------------------------------------------------------- model
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("s", [24, 8])
def test_train_loss_and_every_gradient_match_reference(remat, s):
    """P + s = 32 positions (two 16-key chunks) or 16 (one)."""
    cfg_j, cfg_t = _cfgs()
    pj, _ = _params(cfg_j)
    H.grads_match(JV, TV, cfg_j, cfg_t, pj, _batch(cfg_j, s=s),
                  remat=remat)


def test_sampled_softmax_train_loss_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=3)
    batch = _batch(cfg_j, seed=3)
    batch["neg_ids"] = np.random.RandomState(5).randint(
        0, cfg_j.vocab, 64).astype(np.int32)
    with torch.no_grad():
        got = TV.train_loss(cfg_t, pt, {k: H.t(v) for k, v in batch.items()},
                            sampled_softmax=True)
    H.close(got, JV.train_loss(cfg_j, pj, batch, sampled_softmax=True))


def test_loss_reads_only_the_text_positions():
    """The patches' positions carry no label: the loss equals the text
    rows' loss from a forward of the whole prefix (the port's own
    backbone), and the patches reach it only through attention."""
    _, cfg_t = _cfgs()
    p = TV.init(torch.Generator().manual_seed(1), cfg_t)
    b = {k: H.t(v) for k, v in _batch(cfg_t, seed=1).items()}
    with torch.no_grad():
        loss = TV.train_loss(cfg_t, p, b)
        x = TV._prefix(cfg_t, p, b["patches"], b["tokens"])
        h, aux = TT.backbone_train(cfg_t, p, x, TT._positions(
            2, x.shape[1], CPU), remat=False)
        logits = TT.logits_fn(cfg_t, p, h[:, cfg_t.n_patches:])
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg_t.vocab), b["labels"].reshape(-1).long())
    H.close(loss, (want + 0.01 * aux).numpy())


def test_prefill_and_decode_match_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=2)
    batch = _batch(cfg_j, s=12, seed=2)
    P = cfg_j.n_patches
    jlog, jc = JV.prefill(cfg_j, pj, batch["patches"], batch["tokens"], 32)
    with torch.no_grad():
        tlog, tc = TV.prefill(cfg_t, pt, H.t(batch["patches"]),
                              H.t(batch["tokens"]), 32)
    assert int(tc["len"]) == int(jc["len"]) == P + 12
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for _ in range(4):
        H.close(tlog, jlog)
        for k in ("k", "v"):
            H.close(tc[k], jc[k], H.MODEL, k)
        assert int(tc["len"]) == int(jc["len"])
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jc = JV.decode_step(cfg_j, pj, jc, jnp.asarray(nxt))
        with torch.no_grad():
            tlog, tc = TV.decode_step(cfg_t, pt, tc, H.t(nxt))
    # a text-only prefill is the transformer's (no patches: P = 0)
    tok = batch["tokens"]
    H.close(TT.prefill(cfg_t, pt, H.t(tok), 16)[0].detach(),
            JT.prefill(cfg_j, pj, jnp.asarray(tok), 16)[0])


def test_decode_agrees_with_prefill_of_the_prefix():
    _, cfg_t = _cfgs()
    gen = torch.Generator().manual_seed(3)
    p = TV.init(gen, cfg_t)
    patches = torch.randn((2, cfg_t.n_patches, cfg_t.d_model),
                          generator=gen)
    tok = torch.randint(1, cfg_t.vocab, (2, 12), generator=gen,
                        dtype=torch.int32)
    with torch.no_grad():
        logits, cache = TV.prefill(cfg_t, p, patches, tok, 28)
        seq = tok
        for _ in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = TV.decode_step(cfg_t, p, cache, nxt)
            want, _ = TV.prefill(cfg_t, p, patches, seq)
            H.close(logits, want.numpy())


# --------------------------------------------------------- entry points
def test_cs_adam_trajectory_on_xla_matches_reference(monkeypatch):
    """30 steps at vocab 2,048 (both tables clear ``min_rows`` 1,024 and
    are sketched: B3's plain version, M and V)."""
    cfg_j, cfg_t = _cfgs(vocab_size=2048)
    batches = [_batch(cfg_j, seed=10 + i) for i in range(30)]
    state = H.trajectory(JV, JS, TS, cfg_j, cfg_t, batches, monkeypatch)
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
    m = H.mesh(shape, names)
    want, got = H.serve_specs(monkeypatch, jconfigs.get(ARCH),
                              tconfigs.get(ARCH), m)
    assert got == want


def test_launcher_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                                capsys):
    (jline, jloss), (tline, tloss) = H.launcher_lines(
        tmp_path, monkeypatch, capsys, ["--arch", ARCH, "--reduced",
                                        "--batch", "2", "--seq", "32"])
    assert tline.startswith("[train] arch=internvl2-2b-smoke "
                            "optimizer=cs_adam dp=False steps=3 loss ")
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-3)


def test_make_serve_step_reads_the_patches():
    cfg = tconfigs.get(ARCH).reduced()
    from repro_torch.serve import make_serve_step
    ss = make_serve_step(cfg, batch=2, max_seq=40)
    p = TV.init(torch.Generator().manual_seed(0), cfg)
    b = _batch(cfg, s=8)
    logits, cache = ss.prefill_fn(p, {"patches": H.t(b["patches"]),
                                      "tokens": H.t(b["tokens"])})
    assert logits.shape == (2, cfg.vocab) and int(cache["len"]) == 16
    shape = {k: tuple(v.shape) for k, v in ss.cache_shape().items()}
    assert shape == {k: tuple(v.shape) for k, v in cache.items()}
    logits, cache = ss.decode_fn(p, cache, logits.argmax(-1).int())
    assert int(cache["len"]) == 17


@pytest.mark.parametrize("zero", [True, False])
def test_zero_patches_overflow_as_in_the_reference(zero):
    """The launchers' zero stub patches stay exactly zero through every
    layer, where rmsnorm's backward multiplies by 1/sqrt(eps) = 1,000 a
    norm: at 16 layers the gradient overflows and the step's grad norm
    is NaN in both packages alike (the reference's launcher feeds the
    zeros; the port's follows it).  Normal patches give a finite one."""
    cfg_j, cfg_t = _cfgs(n_layers=16)
    jts = JS.make_train_step(cfg_j)
    tts = TS.make_train_step(cfg_t, device=CPU)
    params = jts.init_fn(jax.random.PRNGKey(0))
    state = jts.optimizer.init(params)
    tp = convert.tree_from_numpy(jax.device_get(params), CPU)
    ts = convert.tree_from_numpy(jax.device_get(state), CPU)
    batch = _batch(cfg_j, s=16)
    if zero:
        batch["patches"] = np.zeros_like(batch["patches"])
    _, _, jm = jts.step_fn(params, state, H.as_jax(batch))
    _, _, tm = H.port_step(tts, tp, ts, batch)
    H.close(float(tm["loss"]), float(jm["loss"]))
    assert np.isnan(float(jm["grad_norm"])) == zero
    assert np.isnan(float(tm["grad_norm"])) == zero
