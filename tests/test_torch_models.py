"""The port's LM stack (``repro_torch.models``, ``configs``) against the
JAX package on the CPU: the same numpy inputs through both.

Tolerances: the building blocks (norms, rope, losses) rtol 1e-5 /
atol 1e-6, the f32 numbers of one op; attention within the reference's
own envelopes (``tests/test_models.py:75-107``: atol 1e-4 forward, 1e-3
gradients); the whole model (``train_loss`` and every gradient leaf,
prefill and decode logits) rtol 1e-4 / atol 1e-5 in f32 compute
(``reduced()``), where XLA and torch order their sums differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT

CPU = torch.device("cpu")
OP = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **tol)


def _cfgs(**over):
    return (jconfigs.get("qwen2_0_5b").reduced(**over),
            tconfigs.get("qwen2_0_5b").reduced(**over))


def _params(cfg_j, seed=0):
    pj = jax.device_get(JT.init(jax.random.PRNGKey(seed), cfg_j))
    return pj, convert.tree_from_numpy(pj, CPU)


def _batch(cfg, b=2, s=32, seed=0):
    tok = np.random.RandomState(seed).randint(1, cfg.vocab, (b, s)) \
        .astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": _t(tok), "labels": _t(lab)})


# ---------------------------------------------------------------- configs
def _shared_and_own(j, t):
    """The port's config as (the reference's fields, the port's own
    fields), the latter checked to be at their defaults."""
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    own = {k: v for k, v in td.items() if k not in jd}
    defaults = {f.name: f.default for f in dataclasses.fields(t)}
    assert own == {k: defaults[k] for k in own}
    return {k: v for k, v in td.items() if k in jd}, own


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    jd = dataclasses.asdict(j)
    assert jd == _shared_and_own(j, t)[0]
    assert (j.vocab, str(j.dtype)) == (t.vocab, str(t.dtype).split(".")[1])
    assert dataclasses.asdict(j.reduced()) == \
        _shared_and_own(j.reduced(), t.reduced())[0]
    assert t.reduced().dtype == torch.float32


def test_aliases_and_shapes_match_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for alias in jconfigs._ALIASES:
        assert tconfigs.get(alias) == tconfigs.get(jconfigs._ALIASES[alias])
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


# ------------------------------------------------------------ blocks
def test_norms_and_rope_match_reference():
    rs = np.random.RandomState(0)
    x, sc, bi = _np(rs, 2, 5, 64), _np(rs, 64), _np(rs, 64)
    _close(TC.rmsnorm(_t(x), _t(sc)), JC.rmsnorm(x, sc), OP)
    _close(TC.layernorm(_t(x), _t(sc), _t(bi)), JC.layernorm(x, sc, bi), OP)
    _close(TC.rope_freqs(32, device=CPU), JC.rope_freqs(32), OP)
    q = _np(rs, 2, 7, 3, 32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    _close(TC.apply_rope(_t(q), _t(pos), 1e6),
           JC.apply_rope(q, pos, 1e6), dict(rtol=1e-5, atol=1e-5))
    _close(TC.sinusoidal_positions(9, 16, CPU), JC.sinusoidal_positions(9, 16),
           dict(rtol=1e-5, atol=1e-5))


def test_losses_and_their_gradients_match_reference():
    rs = np.random.RandomState(1)
    b, s, d, V = 2, 8, 16, 40
    x, table = _np(rs, b, s, d), _np(rs, V, d, scale=0.3)
    labels = rs.randint(0, V, (b, s)).astype(np.int32)
    logits = _np(rs, b, s, V)
    mask = (rs.rand(b, s) > 0.3).astype(np.float32)
    _close(TC.softmax_xent(_t(logits), _t(labels)),
           JC.softmax_xent(logits, labels), OP)
    _close(TC.softmax_xent(_t(logits), _t(labels), _t(mask)),
           JC.softmax_xent(logits, labels, mask), OP)
    for chunk in (4, 8, 3):          # 3 does not divide s: one chunk
        jl, (jgx, jgt) = jax.value_and_grad(
            lambda a, t: JC.chunked_softmax_xent(a, t, labels, chunk),
            argnums=(0, 1))(x, table)
        tx, tt = _t(x).requires_grad_(), _t(table).requires_grad_()
        tl = TC.chunked_softmax_xent(tx, tt, _t(labels), chunk)
        tl.backward()
        _close(tl, jl, OP)
        _close(tx.grad, jgx, OP)
        _close(tt.grad, jgt, OP)
    xs = x.reshape(b * s, d)
    neg = rs.randint(0, V, 12).astype(np.int32)
    neg[0] = labels.reshape(-1)[0]          # an accidental hit
    _close(TC.sampled_softmax_xent(_t(xs), _t(table), _t(labels.reshape(-1)),
                                   _t(neg)),
           JC.sampled_softmax_xent(xs, table, labels.reshape(-1), neg), OP)


# ---------------------------------------------------------- attention
ENV_FWD, ENV_GRAD = dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 16])
def test_attention_forward_matches_reference(causal, q_offset):
    rs = np.random.RandomState(2)
    q = _np(rs, 2, 48, 8, 16)
    k, v = _np(rs, 2, 64, 2, 16), _np(rs, 2, 64, 2, 16)
    jo = JA.chunked_attention(q, k, v, causal=causal, chunk=16,
                              q_offset=q_offset)
    _close(TA.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                chunk=16, q_offset=q_offset), jo, ENV_FWD)
    jf = JA.flash_attention(q, k, v, causal, 16, q_offset)
    tf = TA.flash_attention(_t(q), _t(k), _t(v), causal, 16, q_offset)
    _close(tf, jf, ENV_FWD)
    _close(tf, jo, ENV_FWD)
    # a ragged length falls back to the single-chunk oracle
    _close(TA.flash_attention(_t(q), _t(k[:, :60]), _t(v[:, :60]), causal,
                              16, q_offset),
           JA.flash_attention(q, k[:, :60], v[:, :60], causal, 16, q_offset),
           ENV_FWD)


def test_flash_gradients_match_reference():
    rs = np.random.RandomState(3)
    q = _np(rs, 2, 32, 4, 8)
    k, v = _np(rs, 2, 32, 2, 8), _np(rs, 2, 32, 2, 8)
    jg = jax.grad(lambda *a: jnp.sum(jnp.square(
        JA.flash_attention(*a, True, 8, 0))), argnums=(0, 1, 2))(q, k, v)
    jc = jax.grad(lambda *a: jnp.sum(jnp.square(
        JA.chunked_attention(*a, causal=True, chunk=8))),
        argnums=(0, 1, 2))(q, k, v)
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    torch.sum(torch.square(TA.flash_attention(*ts, True, 8, 0))).backward()
    tc = [_t(a).requires_grad_() for a in (q, k, v)]
    torch.sum(torch.square(TA.chunked_attention(*tc, causal=True,
                                                chunk=8))).backward()
    for t, c, a, b in zip(ts, tc, jg, jc):
        _close(t.grad, a, ENV_GRAD)
        _close(t.grad, b, ENV_GRAD)
        _close(c.grad, b, ENV_GRAD)
        # far inside the envelope: both packages run the same f32 scan
        _close(t.grad, a, dict(rtol=1e-5, atol=1e-5))


def test_decode_attention_matches_reference():
    rs = np.random.RandomState(4)
    b, S, hq, hkv, hd = 3, 24, 4, 2, 8
    q = _np(rs, b, 1, hq, hd)
    ck, cv = _np(rs, b, S, hkv, hd), _np(rs, b, S, hkv, hd)
    for length in (17, np.array([5, 24, 11], np.int32)):
        _close(TA.decode_attention(_t(q), _t(ck), _t(cv),
                                   torch.as_tensor(length)),
               JA.decode_attention(q, ck, cv, jnp.asarray(length)), ENV_FWD)
    qs = _np(rs, 1, 16, hq, hd)
    full = TA.chunked_attention(_t(qs), _t(ck[:1, :16]), _t(cv[:1, :16]),
                                causal=True, chunk=16)
    dec = TA.decode_attention(_t(qs[:, -1:]), _t(ck[:1, :16]),
                              _t(cv[:1, :16]), 16)
    _close(dec, full[:, -1:], ENV_FWD)


# -------------------------------------------------------------- model
def test_params_tree_matches_reference_and_keeps_two_tables():
    """The reference builds ``tok_embed/table`` and ``lm_head/table``
    although qwen2-0.5b says ``tie_embeddings=True`` (read by no code);
    the port keeps the same two tables, the same paths and shapes."""
    for cfg_j, cfg_t in (_cfgs(), (jconfigs.get("qwen2_0_5b"),
                                   tconfigs.get("qwen2_0_5b"))):
        assert cfg_t.tie_embeddings
        js = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), cfg_j))
        ts = TT.init(None, cfg_t, device="meta")
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path):
                 tuple(x.shape)
                 for path, x in jax.tree_util.tree_flatten_with_path(js)[0]}
        tflat = {p: tuple(x.shape) for p, x in leaf_paths(ts)}
        assert jflat == tflat
        assert tflat["tok_embed/table"] == tflat["lm_head/table"] == \
            (cfg_t.vocab, cfg_t.d_model)
    gen = torch.Generator().manual_seed(0)
    p = TT.init(gen, _cfgs()[1])
    assert not torch.equal(p["tok_embed"]["table"], p["lm_head"]["table"])
    assert all(x.dtype == torch.float32 for _, x in leaf_paths(p))
    # the reference's scales: 0.02 for the tables, 1/sqrt(d_in) for weights
    assert abs(float(p["lm_head"]["table"].std()) - 0.02) < 0.002
    w = p["layers"]["ffn"]["w_down"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05


@pytest.mark.parametrize("remat", [True, False])
def test_train_loss_and_every_gradient_match_reference(remat):
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j)
    bj, bt = _batch(cfg_j)
    jl, jg = jax.value_and_grad(
        lambda p: JT.train_loss(cfg_j, p, bj, remat=remat))(pj)
    live = convert.tree_from_numpy(pj, CPU)
    for _p, x in leaf_paths(live):
        x.requires_grad_(True)
    tl = TT.train_loss(cfg_t, live, bt, remat=remat)
    tl.backward()
    _close(tl, jl, MODEL)
    jgrads = dict(leaf_paths(jax.device_get(jg)))
    tpaths = leaf_paths(live)
    assert sorted(p for p, _ in tpaths) == sorted(jgrads)
    for path, x in tpaths:
        _close(x.grad, jgrads[path], MODEL)
    # the head's table gets a gradient apart from the embedding's
    assert float(live["lm_head"]["table"].grad.abs().sum()) > 0


@pytest.mark.parametrize("arch", ["yi_9b", "granite_20b", "internlm2_20b"])
def test_gqa_family_matches_reference(arch):
    """The family's other members at ``reduced()``: no QKV bias, and KV
    heads replicated up to hq (``repeat_kv``: granite, internlm2)."""
    cfg_j = jconfigs.get(arch).reduced()
    cfg_t = tconfigs.get(arch).reduced()
    pj, pt = _params(cfg_j, seed=4)
    bj, bt = _batch(cfg_j, seed=4)
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(cfg_j, p, bj))(pj)
    for _p, x in leaf_paths(pt):
        x.requires_grad_(True)
    tl = TT.train_loss(cfg_t, pt, bt)
    tl.backward()
    _close(tl, jl, MODEL)
    jgrads = dict(leaf_paths(jax.device_get(jg)))
    for path, x in leaf_paths(pt):
        _close(x.grad, jgrads[path], MODEL)
    jlog, _ = JT.prefill(cfg_j, pj, bj["tokens"], 40)
    with torch.no_grad():
        tlog, _ = TT.prefill(cfg_t, pt, bt["tokens"], 40)
    _close(tlog, jlog, MODEL)


def test_sampled_softmax_train_loss_matches_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=1)
    bj, bt = _batch(cfg_j, seed=1)
    neg = np.random.RandomState(5).randint(0, cfg_j.vocab, 64) \
        .astype(np.int32)
    bj["neg_ids"], bt["neg_ids"] = jnp.asarray(neg), _t(neg)
    _close(TT.train_loss(cfg_t, pt, bt, sampled_softmax=True),
           JT.train_loss(cfg_j, pj, bj, sampled_softmax=True), MODEL)


def test_prefill_and_decode_match_reference():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, seed=2)
    tok = np.random.RandomState(6).randint(1, cfg_j.vocab, (2, 20)) \
        .astype(np.int32)
    jlog, jcache = JT.prefill(cfg_j, pj, jnp.asarray(tok), 32)
    with torch.no_grad():
        tlog, tcache = TT.prefill(cfg_t, pt, _t(tok), 32)
    _close(tlog, jlog, MODEL)
    _close(tcache["k"], jcache["k"], MODEL)
    _close(tcache["v"], jcache["v"], MODEL)
    assert int(tcache["len"]) == int(jcache["len"]) == 20
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jcache = JT.decode_step(cfg_j, pj, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            tlog, tcache = TT.decode_step(cfg_t, pt, tcache, _t(nxt))
        _close(tlog, jlog, MODEL)
        _close(tcache["k"], jcache["k"], MODEL)
        assert int(tcache["len"]) == int(jcache["len"])


def test_decode_agrees_with_prefill_of_the_prefix():
    """Each decoded token's logits equal a prefill of the prefix it
    extends (f32 compute, MODEL tolerance)."""
    _, cfg_t = _cfgs()
    gen = torch.Generator().manual_seed(3)
    p = TT.init(gen, cfg_t)
    tok = torch.randint(1, cfg_t.vocab, (2, 12), generator=gen,
                        dtype=torch.int32)
    with torch.no_grad():
        logits, cache = TT.prefill(cfg_t, p, tok, 20)
        seq = tok
        for _ in range(4):
            nxt = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            logits, cache = TT.decode_step(cfg_t, p, cache, nxt)
            want, _ = TT.prefill(cfg_t, p, seq)
            _close(logits, want.numpy(), MODEL)


def test_families_outside_the_slice_raise():
    """Every family has its module; the transformer still refuses the
    rwkv6 and hybrid families and names ``family_module``."""
    from repro_torch.models import encdec, mamba, rwkv, vlm
    from repro_torch.serve import make_serve_step
    from repro_torch.train.steps import family_module
    for arch, mod in (("rwkv6_7b", rwkv), ("zamba2_2_7b", mamba)):
        cfg = tconfigs.get(arch).reduced()
        assert family_module(cfg) is mod
        with pytest.raises(NotImplementedError, match="family_module"):
            TT.init(None, cfg, device="meta")
        ss = make_serve_step(cfg, batch=1, max_seq=8)
        shape = ss.cache_shape()
        assert int(shape["len"]) == 0
        assert {k for k, _ in leaf_paths(ss.params_shape())} == {
            k for k, _ in leaf_paths(mod.init(None, cfg, device="meta"))}
    assert family_module(tconfigs.get("yi_9b")) is TT
    assert family_module(tconfigs.get("whisper_medium")) is encdec
    assert family_module(tconfigs.get("internvl2_2b")) is vlm
