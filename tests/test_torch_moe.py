"""The port's MoE layer (``repro_torch.models.moe``) and the MoE family of
its transformer against the JAX package on the CPU.

Inputs are drawn from seeds with numpy and each package gets its own
copy (the JAX params carry across through ``repro_torch.convert``).
Everything computes in f32.  Held to the reference:

* the integers, to the bit: ``_capacity`` and ``_n_groups`` over a grid,
  and ``_dispatch_group``'s ``ts``, ``slot`` and ``keep`` (and its
  gathered buffer and sorted gates) on the reference's own router
  output ``(eids, gates)``, with and without dropped assignments;
* ``moe_apply``'s output, aux loss and every gradient: rtol 1e-4, atol
  1e-5 times the leaf's largest magnitude (at least 1e-5): XLA and torch
  order the products' sums differently, and a weight's gradient sums 256
  tokens' O(1) terms into values near 16, whose f32 sums then differ by
  about 1e-5 where they cancel.  The port adds each token's K rows in
  the reference's order.  Routing is an
  integer decision on f32 probabilities, so the test prints the smallest
  top-K margin its inputs leave;
* qwen2-moe-a2.7b and llama4-maverick at ``reduced()``: the params tree,
  ``train_loss`` and every gradient (remat on and off), prefill and
  decode (rtol 1e-4, atol 1e-5), and decode against a prefill of the
  longer prefix (the reference's own ``atol=5e-2``,
  ``tests/test_models.py:182-216``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JCfg
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.partition import leaf_paths
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.config import ArchConfig as TCfg

CPU = torch.device("cpu")
MODEL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen2_moe_a2_7b", "llama4_maverick_400b_a17b"]
LAYER = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
             n_kv=2, d_ff=32, vocab_size=512, head_dim=16, n_experts=4,
             top_k=2, shared_d_ff=32, compute_dtype="float32",
             moe_groups=4, capacity_factor=1.25)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**over):
    kw = dict(LAYER, **over)
    return JCfg(**kw), TCfg(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=MODEL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


def _close_scaled(got, want, msg=""):
    """MODEL's rtol, its atol times max(1, the largest |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=msg,
                               rtol=MODEL["rtol"],
                               atol=MODEL["atol"] * scale)


def _layer_params(cfg_j, seed=0, router_scale=8.0):
    """The reference's ``moe_init`` as numpy, its router scaled up so the
    tokens' choices spread."""
    p = jax.device_get(JM.moe_init(jax.random.PRNGKey(seed), cfg_j))
    p["router"] = (np.asarray(p["router"]) * router_scale).astype(np.float32)
    return p


def _tokens(T=256, d=64, seed=1, router=None, lift=1.0):
    """(T, d) normals; with ``router``, each token also carries the one
    vector that adds ``lift`` to expert 0's logit and nothing to the
    others', so expert 0 is over-subscribed and capacity 1.25 drops
    assignments."""
    x = np.random.RandomState(seed).standard_normal((T, d))
    if router is not None:
        r = np.asarray(router, np.float64)
        e0 = np.zeros(r.shape[1])
        e0[0] = lift
        x = x + r @ np.linalg.solve(r.T @ r, e0)
    return x.astype(np.float32)


def _route_j(cfg_j, p, x):
    """The reference's router output (the lines of ``moe_apply``)."""
    logits = (jnp.asarray(x) @ jnp.asarray(p["router"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gates, eids = jax.lax.top_k(probs, cfg_j.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    return np.asarray(probs), np.asarray(eids), np.asarray(gates)


def _margin(probs, K):
    """The smallest gap between the K-th and the (K+1)-th probability
    (and between the chosen ones, whose order the aux loss reads)."""
    s = -np.sort(-probs, axis=-1)[:, :K + 1]
    return float(np.min(s[:, :-1] - s[:, 1:]))


# -------------------------------------------------------------- init, sizes
@pytest.mark.parametrize("shared", [32, 0])
def test_moe_init_tree_matches_reference_and_carries_across(shared):
    cfg_j, cfg_t = _cfgs(shared_d_ff=shared)
    pj = jax.device_get(JM.moe_init(jax.random.PRNGKey(0), cfg_j))
    tflat = {p: tuple(x.shape) for p, x in leaf_paths(
        TM.moe_init(None, cfg_t, device="meta"))}
    jflat = {p: tuple(x.shape) for p, x in leaf_paths(pj)}
    assert tflat == jflat
    assert ("shared/w_up" in tflat) == bool(shared)
    assert tflat["w_gate"] == (4, 64, 32) and tflat["w_down"] == (4, 32, 64)
    pt = convert.tree_from_numpy(pj, CPU)
    for path, x in leaf_paths(pt):
        assert np.array_equal(x.numpy(), dict(leaf_paths(pj))[path])
    # the reference's scales: router 0.02, experts 1/sqrt(d_in)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg_t, device=CPU)
    assert abs(float(p["router"].std()) - 0.02) < 0.004
    assert abs(float(p["w_down"].std()) * np.sqrt(32) - 1.0) < 0.05


def test_full_width_trees_match_reference_on_meta():
    for arch in ARCHS:
        cfg_j, cfg_t = jconfigs.get(arch), tconfigs.get(arch)
        js = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), cfg_j))
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path):
                 tuple(x.shape)
                 for path, x in jax.tree_util.tree_flatten_with_path(js)[0]}
        ts = TT.init(None, cfg_t, device="meta")
        tflat = {p: tuple(x.shape) for p, x in leaf_paths(ts)}
        assert tflat == jflat
        assert all(x.device.type == "meta" for _, x in leaf_paths(ts))
    n = sum(int(np.prod(s)) for s in tflat.values())
    assert "layers/moe/ffn/w_gate" in tflat and "layers/dense/ffn/w_up" \
        in tflat and n > 3.9e11            # llama4: ~400 B
    q = TT.init(None, tconfigs.get(ARCHS[0]), device="meta")
    assert sum(x.numel() for _, x in leaf_paths(q)) == 14_315_587_584


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 8.0, 60.0])
@pytest.mark.parametrize("E", [4, 60, 128])
def test_capacity_and_groups_equal_reference(cf, E):
    cfg_j, cfg_t = _cfgs(capacity_factor=cf, n_experts=E)
    for n in (1, 4, 7, 32, 128, 1024, 4096, 32768):
        assert TM._capacity(cfg_t, n) == JM._capacity(cfg_j, n)
    for groups in (1, 3, 4, 32):
        cj, ct = (dataclasses.replace(c, moe_groups=groups)
                  for c in (cfg_j, cfg_t))
        for T in (1, 5, 8, 12, 96, 1024, 8192):
            assert TM._n_groups(ct, T) == JM._n_groups(cj, T)


# ------------------------------------------------------------------ dispatch
@pytest.mark.parametrize("cf,drops", [(1.25, True), (8.0, False)])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_integers_bit_equal_on_the_references_routing(cf, drops,
                                                               top_k):
    cfg_j, cfg_t = _cfgs(capacity_factor=cf, top_k=top_k)
    p = _layer_params(cfg_j)
    x = _tokens(T=64, router=p["router"])
    _, eids, gates = _route_j(cfg_j, p, x)
    C = JM._capacity(cfg_j, 64 * top_k)
    jxe, jts, jslot, jkeep, jgs = jax.device_get(JM._dispatch_group(
        cfg_j, jnp.asarray(x), jnp.asarray(eids), jnp.asarray(gates), C))
    txe, tts, tslot, tkeep, tgs = TM._dispatch_group(
        cfg_t, _t(x), _t(eids), _t(gates), C)
    assert np.array_equal(tts.numpy(), jts)
    assert np.array_equal(tslot.numpy(), jslot)
    assert np.array_equal(tkeep.numpy(), jkeep)
    assert np.array_equal(tgs.numpy(), jgs)
    assert np.array_equal(txe.numpy(), jxe)
    assert bool((~jkeep).any()) == drops
    # the combine of the reference's own expert outputs
    ye = np.random.RandomState(4).standard_normal(jxe.shape) \
        .astype(np.float32)
    want = JM._combine_group(cfg_j, jnp.asarray(ye), jnp.asarray(jts),
                             jnp.asarray(jslot), jnp.asarray(jkeep),
                             jnp.asarray(jgs), 64)
    got = TM._combine_group(cfg_t, _t(ye), tts, tslot, tkeep, tgs, 64)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))


# ------------------------------------------------------------------- the layer
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("shared", [32, 0])
def test_moe_apply_and_gradients_match_reference(shared, top_k, cf, groups):
    cfg_j, cfg_t = _cfgs(shared_d_ff=shared, top_k=top_k,
                         capacity_factor=cf, moe_groups=groups)
    pj = _layer_params(cfg_j, seed=2)
    x = _tokens(seed=3, router=pj["router"])
    dy = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)
    probs, _, _ = _route_j(cfg_j, pj, x)
    print(f"smallest top-{top_k} margin {_margin(probs, top_k):.3e}")
    (jy, ja), vjp = jax.vjp(lambda p, x: JM.moe_apply(cfg_j, p, x),
                            jax.tree_util.tree_map(jnp.asarray, pj),
                            jnp.asarray(x))
    jgp, jgx = jax.device_get(vjp((jnp.asarray(dy),
                                   jnp.asarray(1.0, jnp.float32))))
    pt = convert.tree_from_numpy(pj, CPU)
    for _p, leaf in leaf_paths(pt):
        leaf.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    ty, ta = TM.moe_apply(cfg_t, pt, xt)
    (torch.sum(ty * _t(dy)) + ta).backward()
    _close_scaled(ty, jy, msg="y")
    _close(ta, ja, msg="aux")
    _close_scaled(xt.grad, jgx, msg="dx")
    jg = dict(leaf_paths(jgp))
    assert sorted(p for p, _ in leaf_paths(pt)) == sorted(jg)
    for path, leaf in leaf_paths(pt):
        _close_scaled(leaf.grad, jg[path], msg=path)
    # the drop count against the reference's dispatch
    G = JM._n_groups(cfg_j, x.shape[0])
    _, eids, gates = _route_j(cfg_j, pj, x)
    C = JM._capacity(cfg_j, x.shape[0] // G * top_k)
    keep = jax.vmap(lambda xi, ei, gi: JM._dispatch_group(
        cfg_j, xi, ei, gi, C)[3])(jnp.asarray(x).reshape(G, -1, 64),
                                  jnp.asarray(eids).reshape(G, -1, top_k),
                                  jnp.asarray(gates).reshape(G, -1, top_k))
    n_drop = int((~np.asarray(keep)).sum())
    with torch.no_grad():
        _, tg, te = TM.route_probs(cfg_t, pt, _t(x))
        tkeep = TM._route(cfg_t, te.reshape(G, -1, top_k),
                          tg.reshape(G, -1, top_k), C)[2]
    assert np.array_equal(tkeep.numpy(), np.asarray(keep))
    assert (n_drop > 0) == (cf == 1.25)


def test_grouped_equals_global_without_drops():
    """The reference's ``tests/test_models.py:167`` on the port, and both
    against the reference."""
    cfg_j, cfg_t = _cfgs(top_k=2, capacity_factor=8.0, moe_groups=4)
    pj = jax.device_get(JM.moe_init(jax.random.PRNGKey(0), cfg_j))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 64)))
    pt = convert.tree_from_numpy(pj, CPU)
    with torch.no_grad():
        y1, a1 = TM.moe_apply(cfg_t, pt, _t(x))
        y2, a2 = TM.moe_apply(dataclasses.replace(cfg_t, moe_groups=1), pt,
                              _t(x))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)
    jy, ja = JM.moe_apply(cfg_j, pj, jnp.asarray(x))
    _close(y1, jy)
    _close(a1, ja)


def test_fixed_order_sums_give_the_same_bits_twice():
    """The combine and the dispatch gather's backward add each token's K
    rows in one order: two runs give the same bits."""
    cfg_j, cfg_t = _cfgs(top_k=2, capacity_factor=1.25, moe_groups=4)
    pj = _layer_params(cfg_j, seed=6)
    x = _tokens(seed=7, router=pj["router"])
    outs = []
    for _ in range(2):
        pt = convert.tree_from_numpy(pj, CPU)
        for _p, leaf in leaf_paths(pt):
            leaf.requires_grad_(True)
        xt = _t(x).requires_grad_(True)
        y, a = TM.moe_apply(cfg_t, pt, xt)
        (torch.sum(y * y) + a).backward()
        outs.append([y.detach(), xt.grad] + [leaf.grad for _p, leaf in
                                             leaf_paths(pt)])
    assert all(torch.equal(u, v) for u, v in zip(*outs))
    # and the sum over each token's K rows is the left-to-right one
    rows = torch.randn(12, 3, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[0, 5, 7], [1, 2, 11], [3, 4, 6], [8, 9, 10]])
    want = (rows[pos[:, 0]] + rows[pos[:, 1]]) + rows[pos[:, 2]]
    assert torch.equal(TM._ordered_sum(rows, pos), want)


# ---------------------------------------------------------------- the models
def _model(arch, seed=0):
    cfg_j, cfg_t = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    pj = jax.device_get(JT.init(jax.random.PRNGKey(seed), cfg_j))
    return cfg_j, cfg_t, pj


def _batch(cfg, b=2, s=32, seed=0):
    tok = np.random.RandomState(seed).randint(1, cfg.vocab, (b, s)) \
        .astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": _t(tok), "labels": _t(lab)})


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_params_tree_matches_reference(arch):
    cfg_j, cfg_t, pj = _model(arch)
    tflat = {p: tuple(x.shape) for p, x in leaf_paths(
        TT.init(None, cfg_t, device="meta"))}
    assert tflat == {p: tuple(x.shape) for p, x in leaf_paths(pj)}
    assert TT.uses_blocks(cfg_t) == JT.uses_blocks(cfg_j) == \
        (arch.startswith("llama4"))
    assert TT.n_scan_units(cfg_t) == JT.n_scan_units(cfg_j)
    p = TT.init(torch.Generator().manual_seed(0), cfg_t)
    assert {q: tuple(x.shape) for q, x in leaf_paths(p)} == tflat


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_loss_and_every_gradient_match_reference(arch, remat):
    cfg_j, cfg_t, pj = _model(arch, seed=1)
    bj, bt = _batch(cfg_j, seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: JT.train_loss(cfg_j, p, bj, remat=remat))(pj)
    live = convert.tree_from_numpy(pj, CPU)
    for _p, x in leaf_paths(live):
        x.requires_grad_(True)
    tl = TT.train_loss(cfg_t, live, bt, remat=remat)
    tl.backward()
    _close(tl, jl)
    jgrads = dict(leaf_paths(jax.device_get(jg)))
    assert sorted(p for p, _ in leaf_paths(live)) == sorted(jgrads)
    for path, x in leaf_paths(live):
        _close(x.grad, jgrads[path], msg=path)
    # the aux loss reaches the router: its gradient is not zero
    routers = [x.grad for p, x in leaf_paths(live) if p.endswith("router")]
    assert routers and all(float(g.abs().sum()) > 0 for g in routers)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_reference(arch):
    cfg_j, cfg_t, pj = _model(arch, seed=2)
    pt = convert.tree_from_numpy(pj, CPU)
    tok = np.random.RandomState(6).randint(1, cfg_j.vocab, (2, 20)) \
        .astype(np.int32)
    jlog, jcache = JT.prefill(cfg_j, pj, jnp.asarray(tok), 32)
    with torch.no_grad():
        tlog, tcache = TT.prefill(cfg_t, pt, _t(tok), 32)
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jcache = JT.decode_step(cfg_j, pj, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            tlog, tcache = TT.decode_step(cfg_t, pt, tcache, _t(nxt))
        _close(tlog, jlog)
        _close(tcache["k"], jcache["k"])
        assert int(tcache["len"]) == int(jcache["len"])


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_decode_agrees_with_prefill_of_the_longer_prefix(arch):
    """``tests/test_models.py``'s serve-consistency check on the port:
    decoding the last token after a prefill of the rest equals a prefill
    of the whole sequence (atol 5e-2, the reference's)."""
    cfg_t = tconfigs.get(arch).reduced()
    from repro_torch.serve import make_serve_step
    gen = torch.Generator().manual_seed(3)
    p = TT.init(gen, cfg_t)
    toks = torch.randint(1, cfg_t.vocab, (1, 12), generator=gen,
                         dtype=torch.int32)
    ss = make_serve_step(cfg_t, batch=1, max_seq=16)
    full, _ = ss.prefill_fn(p, {"tokens": toks})
    _, cache = ss.prefill_fn(p, {"tokens": toks[:, :-1]})
    dec, _ = ss.decode_fn(p, cache, toks[:, -1])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=5e-2)
