"""Parity of the port's dense-gradient path with the JAX reference: the
transforms, the optimizers in the legacy ``{"step", "m", "v"}`` layout,
and the state hand-over of ``repro_torch.convert``.

Both packages take the same gradients, made with numpy from a seed, on a
``{"tok_embed": {"table": (1024, 64)}, "w": (32, 16)}`` tree: the table
is sketched (``SketchPolicy``), ``w`` stays dense.  A third of the
table's rows get a zero gradient each step, so the lazy mask matters.
Tolerance rtol=1e-4, atol=1e-5 after a few steps (``TRAJ_TOL``): single
ulps a step from XLA:CPU's fused multiply-adds and the float32 power in
the bias corrections, which the port takes in float64 and rounds once.

The module runs PyTorch on one CPU thread.  With more, the first
multithreaded ``torch.sqrt`` of a process (at least 2,048 elements) now
and then returns about 1,200 of 16,384 values off by up to 3e-4
relative, a fault of PyTorch's CPU build (torch 2.13.0+cpu) measured in
1 process of 4, and in none of 12 on one thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as JO
from repro.core import transforms as JT
from repro.core.partition import SketchPolicy as JPolicy
from repro.core.partition import leaf_paths as j_leaf_paths
from repro.core.stores import CountMinStore as JCM
from repro.core.stores import CountSketchStore as JCS
from repro_torch import convert
from repro_torch.core import optimizers as TO
from repro_torch.core import partition as TP
from repro_torch.core import transforms as TT
from repro_torch.core.stores import CountMinStore as TCM
from repro_torch.core.stores import CountSketchStore as TCS
from repro_torch.core.stores import Rank1Store

TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
N, D = 1024, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
PATH = "tok_embed/table"


def _grads(rng):
    g = rng.randn(N, D).astype(np.float32) * 0.1
    g[rng.rand(N) < 0.33] = 0.0
    return {"tok_embed": {"table": g},
            "w": rng.randn(32, 16).astype(np.float32)}


def _params():
    return {"tok_embed": {"table": np.zeros((N, D), np.float32)},
            "w": np.zeros((32, 16), np.float32)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree(want, got, exact=False, **tol):
    """``want`` (JAX, any array type) and ``got`` (the port, tensors) hold
    the same keys, None leaves and values."""
    if isinstance(want, dict):
        assert set(want) == set(got), (set(want), set(got))
        for k in want:
            _assert_tree(want[k], got[k], exact, **tol)
        return
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            _assert_tree(a, b, exact, **tol)
        return
    if want is None:
        assert got is None
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), **tol)


def _run(jopt, topt, steps=4, seed=0):
    """Drive both optimizers over the same gradients; every step's updates
    and the final state must agree."""
    rng = np.random.RandomState(seed)
    jstate = jopt.init(_jtree(_params()))
    tstate = topt.init(convert.tree_from_numpy(_params(), "cpu"))
    _assert_tree(jax.device_get(jstate), tstate, exact=True)
    for _ in range(steps):
        g = _grads(rng)
        ju, jstate = jopt.update(_jtree(g), jstate)
        tu, tstate = topt.update(convert.tree_from_numpy(g, "cpu"), tstate)
        _assert_tree(ju, tu, **TRAJ_TOL)
    _assert_tree(jax.device_get(jstate), tstate, **TRAJ_TOL)
    return tstate


def _sketch_stores(pkg, backend=None):
    cs, cm = (JCS, JCM) if pkg == "jax" else (TCS, TCM)
    # width 16: 64 table rows a bucket, so buckets collide across chunks
    return dict(m_store=cs(width=16, backend=backend),
                v_store=cm(width=16, backend=backend))


# backend pinned on the port's stores -> the reference's
ADAM_MODES = {
    "fused_xla": dict(jb="xla", tb="xla"),
    "fused_tiled": dict(jb="xla", tb="tiled"),
    "fused_ref": dict(jb="ref", tb="ref"),
    "chunked": dict(jb=None, tb=None, dense_chunk=300),
    "unchunked": dict(jb=None, tb=None, dense_chunk=0),
    "strict": dict(jb=None, tb=None, strict_paper=True),
    "eager_rows": dict(jb=None, tb=None, lazy=False, dense_chunk=300),
}


@pytest.mark.parametrize("mode", sorted(ADAM_MODES))
def test_scale_by_adam_matches_reference(mode):
    kw = dict(ADAM_MODES[mode])
    jb, tb = kw.pop("jb"), kw.pop("tb")
    jopt = JT.scale_by_adam(where=JPolicy(), **_sketch_stores("jax", jb),
                            **kw)
    topt = TT.scale_by_adam(where=TP.SketchPolicy(),
                            **_sketch_stores("torch", tb), **kw)
    state = _run(jopt, topt)
    assert tuple(state["m"][PATH.split("/")[0]]["table"].shape) == (3, 16, D)
    assert tuple(state["m"]["w"].shape) == (32, 16)     # dense leaf


def test_chunked_reads_the_pre_step_sketch():
    """The chunked form adds into the sketch in place while it reads the
    pre-step estimates: with buckets shared across chunks it must equal
    the one-shot fused form exactly.  Reading the live sketch would let a
    chunk see the chunks before it."""
    rng = np.random.RandomState(3)
    chunked = TT.scale_by_adam(where=TP.SketchPolicy(), dense_chunk=256,
                               **_sketch_stores("torch"))
    fused = TT.scale_by_adam(where=TP.SketchPolicy(),
                             **_sketch_stores("torch", "xla"))
    params = convert.tree_from_numpy(_params(), "cpu")
    sc, sf = chunked.init(params), fused.init(params)
    for _ in range(3):
        g = convert.tree_from_numpy(_grads(rng), "cpu")
        uc, sc = chunked.update(g, sc)
        uf, sf = fused.update(g, sf)
        _assert_tree(convert.tree_to_numpy(uf), uc, exact=True)
    _assert_tree(convert.tree_to_numpy(sf), sc, exact=True)


def test_all_dense_adam_matches_reference():
    _run(JO.adam(1e-3), TO.adam(1e-3))


@pytest.mark.parametrize("backend", [None, "xla", "tiled"])
def test_scale_by_momentum_matches_reference(backend):
    jopt = JT.scale_by_momentum(0.9, m_store=JCS(width=16,
                                                 backend=backend and "xla"),
                                where=JPolicy(), dense_chunk=300)
    topt = TT.scale_by_momentum(0.9, m_store=TCS(width=16, backend=backend),
                                where=TP.SketchPolicy(), dense_chunk=300)
    _run(jopt, topt)


@pytest.mark.parametrize("backend", [None, "xla", "tiled"])
def test_scale_by_adagrad_matches_reference(backend):
    jopt = JT.scale_by_adagrad(v_store=JCM(width=16,
                                           backend=backend and "xla"),
                               where=JPolicy(), dense_chunk=300)
    topt = TT.scale_by_adagrad(v_store=TCM(width=16, backend=backend),
                               where=TP.SketchPolicy(), dense_chunk=300)
    _run(jopt, topt)


@pytest.mark.parametrize("backend", [None, "tiled"])
def test_scale_by_rmsprop_matches_reference(backend):
    jopt = JT.scale_by_rmsprop(v_store=JCM(width=16,
                                           backend=backend and "xla"),
                               where=JPolicy())
    topt = TT.scale_by_rmsprop(v_store=TCM(width=16, backend=backend),
                               where=TP.SketchPolicy())
    state = _run(jopt, topt)
    assert state["m"] == {"tok_embed": {"table": None}, "w": None}


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(np.random.RandomState(1))
    want = JT.clip_by_global_norm(max_norm)(_jtree(g))
    got = TT.clip_by_global_norm(max_norm)(convert.tree_from_numpy(g, "cpu"))
    _assert_tree(want, got, rtol=1e-5, atol=1e-6)
    chain_j = JT.chain(JT.clip_by_global_norm(max_norm),
                       JT.scale_by_adam(where=JPolicy(),
                                        **_sketch_stores("jax", "xla")),
                       JT.scale_by_lr(1e-3))
    chain_t = TT.chain(TT.clip_by_global_norm(max_norm),
                       TT.scale_by_adam(where=TP.SketchPolicy(),
                                        **_sketch_stores("torch", "tiled")),
                       TT.scale_by_lr(1e-3))
    _run(chain_j, chain_t, steps=3)


HP = dict(compression=8.0, width_multiple=16)
WRAPPERS = {
    "adam": (lambda O, P, hp: O.countsketch_adam(
        1e-3, policy=P.SketchPolicy(), hparams=hp)),
    "adam_cs_v": (lambda O, P, hp: O.countsketch_adam(
        1e-3, policy=P.SketchPolicy(), hparams=hp,
        sketch_first_moment=False)),
    "rmsprop": (lambda O, P, hp: O.countsketch_rmsprop(
        1e-3, policy=P.SketchPolicy(), hparams=hp)),
    "momentum": (lambda O, P, hp: O.countsketch_momentum(
        1e-2, policy=P.SketchPolicy(), hparams=hp)),
    "adagrad": (lambda O, P, hp: O.countsketch_adagrad(
        1e-2, policy=P.SketchPolicy(), hparams=hp)),
}


@pytest.mark.parametrize("backend", [None, "xla"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_countsketch_wrappers_match_reference(name, backend):
    from repro.core import partition as JP
    make = WRAPPERS[name]
    jopt = make(JO, JP, JO.SketchHParams(backend=backend, **HP))
    topt = make(TO, TP, TO.SketchHParams(backend=backend, **HP))
    _run(jopt, topt, steps=3)


def test_wrappers_address_the_same_buckets():
    """Leaf paths, the per-leaf specs of the policy bridge and the buckets
    they hash to are the reference's, to the bit."""
    jtree = JO.stores_from_policy(JPolicy(), hparams=JO.SketchHParams(**HP))
    ttree = TO.stores_from_policy(TP.SketchPolicy(),
                                  hparams=TO.SketchHParams(**HP))
    params = _params()
    assert [p for p, _ in TP.leaf_paths(params)] == \
        [p for p, _ in j_leaf_paths(_jtree(params))] == [PATH, "w"]
    ids = np.arange(N, dtype=np.int32)
    for slot in (0, 1):
        js = jtree.resolve(PATH, (N, D), jnp.float32)[slot].spec
        ts = ttree.resolve(PATH, (N, D), torch.float32)[slot].spec
        assert (js.depth, js.width, js.dim, js.seed, js.signed) == \
            (ts.depth, ts.width, ts.dim, ts.seed, ts.signed)
        np.testing.assert_array_equal(
            ts.family.bucket(torch.from_numpy(ids)).numpy(),
            np.asarray(js.family.bucket(jnp.asarray(ids))))
    assert ttree.resolve("w", (32, 16))[0].kind == "dense"


def test_update_read_backend_filter():
    assert TO._update_read_backend("stream") is None
    assert TO._update_read_backend("tiled") == "tiled"
    assert TO._update_read_backend("auto") == "auto"
    assert JO._update_read_backend("stream") is None


def test_rank1_is_not_ported_yet():
    """Ported since: ``Rank1Store`` builds, and ``rank1_policy`` gives a
    leaf a dense m beside a rank-1 v (``tests/test_torch_lowrank.py``
    holds the numbers to the reference)."""
    assert Rank1Store().kind == "rank1"
    opt = TO.countsketch_adam(1e-3, rank1_policy=TP.everything_policy)
    st = opt.init({"t": torch.zeros(2048, 4), "b": torch.zeros(4)})
    assert tuple(st["v"]["t"].r.shape) == (2048,)
    assert tuple(st["v"]["t"].c.shape) == (4,)
    assert tuple(st["m"]["t"].shape) == (2048, 4)
    assert tuple(st["v"]["b"].shape) == (4,)


@pytest.mark.parametrize("backend", ["xla", "tiled"])
def test_dense_path_equals_sparse_path(backend):
    """A row-sparse dense gradient through ``adam_from_stores`` takes the
    sparse-rows step: the same table and sketches after 10 steps of
    duplicate-heavy zipf ids, to the bit on the CPU."""
    from repro_torch.train.steps import sparse_embedding_stores
    n, d, k = 1024, 32, 256
    hp = TO.SketchHParams(backend=backend)
    m_store, v_store = sparse_embedding_stores(n, d, hparams=hp)
    sparse = TO.sparse_rows_adam(1e-2, shape=(n, d), hparams=hp,
                                 m_store=m_store, v_store=v_store,
                                 device="cpu")
    tree = TO.StoreTree(rules=(("emb", m_store, v_store),)).with_backend(
        backend)
    dense = TO.adam_from_stores(1e-2, tree)
    rng = np.random.RandomState(0)
    table0 = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    t_sparse, t_dense = table0.clone(), {"emb": table0.clone()}
    s_sparse, s_dense = sparse.init(), dense.init(t_dense)
    for _ in range(10):
        ids = torch.from_numpy(((rng.zipf(1.3, k) - 1) % n).astype(np.int32))
        rows = torch.from_numpy(rng.randn(k, d).astype(np.float32))
        u, s_sparse = sparse.update({"ids": ids, "rows": rows}, s_sparse)
        TO.apply_sparse_updates(t_sparse, u)
        g = torch.zeros(n, d).index_add_(0, ids.long(), rows)
        u, s_dense = dense.update({"emb": g}, s_dense)
        TO.apply_updates(t_dense, u)
    assert torch.equal(t_dense["emb"], t_sparse)
    assert torch.equal(s_dense["m"]["emb"], s_sparse["m"])
    assert torch.equal(s_dense["v"]["emb"], s_sparse["v"])


def test_legacy_state_round_trip():
    """A nested reference state with None, dense and sketch leaves goes to
    the port and back unchanged, and the port steps on from it as the
    reference does."""
    hp = dict(compression=8.0, width_multiple=16)
    jopt = JO.countsketch_adam(1e-3, policy=JPolicy(),
                               hparams=JO.SketchHParams(**hp))
    topt = TO.countsketch_adam(1e-3, policy=TP.SketchPolicy(),
                               hparams=TO.SketchHParams(**hp))
    rng = np.random.RandomState(4)
    jstate = jopt.init(_jtree(_params()))
    _, jstate = jopt.update(_jtree(_grads(rng)), jstate)
    host = jax.device_get(jstate)
    tstate = convert.tree_from_numpy(host, "cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    back = convert.tree_to_numpy(tstate)
    _assert_tree(host, back, exact=True)
    rmsprop = convert.tree_from_numpy(
        jax.device_get(JO.countsketch_rmsprop(
            1e-3, policy=JPolicy(), hparams=JO.SketchHParams(**hp)).init(
                _jtree(_params()))), "cpu")
    assert rmsprop["m"] == {"tok_embed": {"table": None}, "w": None}
    g = _grads(rng)
    ju, jstate = jopt.update(_jtree(g), jstate)
    tu, tstate = topt.update(convert.tree_from_numpy(g, "cpu"), tstate)
    _assert_tree(ju, tu, **TRAJ_TOL)
    _assert_tree(jax.device_get(jstate), tstate, **TRAJ_TOL)


def test_apply_updates_in_place():
    params = convert.tree_from_numpy(_params(), "cpu")
    table = params["tok_embed"]["table"]
    out = TO.apply_updates(params, {"tok_embed": {"table": torch.ones(N, D)},
                                    "w": None})
    assert out["tok_embed"]["table"] is table and float(table.sum()) == N * D
    assert float(out["w"].abs().sum()) == 0.0


def test_softmax_layer_matches_reference():
    """The dense path as a training loop: a softmax layer (cross-entropy
    of ``rmsnorm(h)*scale @ table^T``, a full softmax, so every table row
    has a gradient) under ``countsketch_adam`` at lr 3e-4, gradients from
    autograd and ``jax.grad``.  From step 2 on, rows whose median
    first-moment estimate comes from heavier colliders than their min
    second-moment estimate can take steps far above lr (at full width
    the loss then rises: PERF.md, ``chip_smoke.py`` phase 6); the port
    must take the reference's steps, those included."""
    from repro.core.partition import SketchPolicy as JP
    v, d, t, steps, lr = 4096, 512, 128, 5, 3e-4
    rng = np.random.RandomState(0)
    teacher = rng.randn(v, d).astype(np.float32)
    table0 = (rng.randn(v, d) / np.sqrt(d)).astype(np.float32)
    ys = [((rng.zipf(1.1, t) - 1) % v).astype(np.int32) for _ in range(steps)]
    noise = [rng.randn(t, d).astype(np.float32) for _ in range(steps)]

    def jloss(p, y, n):
        h = jnp.asarray(teacher)[y] + n
        hn = h * jax.lax.rsqrt(jnp.mean(h * h, -1, keepdims=True) + 1e-6) \
            * p["final_norm"]["scale"]
        logp = jax.nn.log_softmax(hn @ p["tok_embed"]["table"].T)
        return -jnp.mean(logp[jnp.arange(t), y])

    jopt = JO.countsketch_adam(lr, policy=JP(),
                               hparams=JO.SketchHParams(backend="xla"))
    jp = {"tok_embed": {"table": jnp.asarray(table0)},
          "final_norm": {"scale": jnp.ones(d)}}
    js, jl = jopt.init(jp), []
    for y, n in zip(ys, noise):
        loss, g = jax.value_and_grad(jloss)(jp, jnp.asarray(y), jnp.asarray(n))
        u, js = jopt.update(g, js, jp)
        jp = JO.apply_updates(jp, u)
        jl.append(float(loss))

    topt = TO.countsketch_adam(lr, policy=TP.SketchPolicy(),
                               hparams=TO.SketchHParams(backend="tiled"))
    tp = convert.tree_from_numpy(jax.device_get(
        {"tok_embed": {"table": table0}, "final_norm": {"scale": np.ones(d)}}),
        "cpu")
    for leaf in (tp["tok_embed"]["table"], tp["final_norm"]["scale"]):
        leaf.requires_grad_()
    ts, tl = topt.init(tp), []
    for y, n in zip(ys, noise):
        y = torch.from_numpy(y).long()
        h = torch.from_numpy(teacher)[y] + torch.from_numpy(n)
        hn = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6) \
            * tp["final_norm"]["scale"]
        loss = torch.nn.functional.cross_entropy(
            hn @ tp["tok_embed"]["table"].t(), y)
        grads = torch.autograd.grad(loss, [tp["tok_embed"]["table"],
                                           tp["final_norm"]["scale"]])
        u, ts = topt.update({"tok_embed": {"table": grads[0]},
                             "final_norm": {"scale": grads[1]}}, ts)
        TO.apply_updates(tp, u)
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_tree(jax.device_get(jp), tp, **TRAJ_TOL)
    _assert_tree(jax.device_get(js), ts, **TRAJ_TOL)
