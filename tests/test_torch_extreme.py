"""The port's extreme-classification workload against the JAX package.

The data streams, the MACH class maps and the dedup ratio are integers
or exact counts, held bit for bit.  ``dense_rows_adam`` is held to the
reference over 3 steps of heavy duplicates (rtol 1e-5, atol 1e-6: one
call per step) and to the port's dense ``adam`` on the scatter-added
gradient (the reference's own test).

``make_extreme_step`` starts from one state (``repro_torch.convert``) and
runs 10 steps of each optimizer beside the reference's (backend ``auto``:
``xla`` on both CPUs), on the reference's test configuration.  Per-step
losses, ``grad_norm``, ``dedup_ratio``, every optimizer-state leaf and
the class head are held within rtol 1e-4, atol 1e-5, as
``tests/test_torch_steps.py`` holds its trajectories; the feature table
too under ``dense_adam``.  The sketched arms' feature table is held to
that tolerance after one step, and after 10 steps on the reference's own
gradients (``test_optimizer_on_reference_gradients``), but not after 10
steps on each package's own gradients: XLA and torch sum the
sampled-softmax products in other orders, so a per-occurrence gradient
row differs by an ulp (held at rtol 1e-5, atol 1e-6 below); a zipf-head
feature's dedup sum cancels dozens of such rows, and at width 256 its
Count-Min second moment can be small, so the table entry's relative
difference grows to 8e-4 (``cs_rmsprop``) and 3e-3 (``cs_adam``) in 10
steps while the moments stay within 1e-7.  Torch runs on one CPU thread,
as in ``test_torch_dense.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as JO
from repro.core.hashing import mach_class_hash as j_mach
from repro.data import pipeline as jp
from repro.train import extreme as jx
from repro_torch import convert
from repro_torch.core import optimizers as TO
from repro_torch.core.hashing import mach_class_hash as t_mach
from repro_torch.data import pipeline as tp
from repro_torch.train import extreme as tx

torch.set_num_threads(1)

KW = dict(n_classes=50_000, n_meta=4096, n_features=2048, dim=16, nnz=8,
          n_negatives=64)
J_CFG, T_CFG = jx.MachConfig(**KW), tx.MachConfig(**KW)
BATCH, LR, STEPS = 32, 1e-2, 10
TOL = dict(rtol=1e-5, atol=1e-6)          # one call
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)     # after a trajectory


# ------------------------------------------------------------- data streams
@pytest.mark.parametrize("seed", [0, 7])
def test_extreme_stream_matches_reference(seed):
    kw = dict(n_features=5_000, n_classes=123_457, batch=24, nnz=6,
              n_negatives=40, alpha=1.05, seed=seed)
    js, ts = jp.ExtremeStream(jp.ExtremeConfig(**kw)), \
        tp.ExtremeStream(tp.ExtremeConfig(**kw))
    for step in (0, 1, 5, 1_000):
        a, b = js.batch(step), ts.batch(step)
        assert set(a) == set(b) == {"features", "labels", "negatives"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert next(ts.batches(3))["labels"].tolist() == \
        js.batch(3)["labels"].tolist()


@pytest.mark.parametrize("seed", [0, 11])
def test_classification_batch_and_label_rule(seed):
    kw = dict(n_features=3_000, n_classes=9_999, batch=16, nnz=5,
              alpha=1.1, seed=seed)
    for step in (0, 2, 9):
        a = jp.classification_batch(step, **kw)
        b = tp.classification_batch(step, **kw)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(
            tp.class_of_features(b["features"], 777),
            jp.class_of_features(a["features"], 777))


@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (5, 2)])
def test_zipf_lm_matches_reference(seed, n_hosts):
    kw = dict(vocab_size=1_000, seq_len=12, global_batch=8, drift_every=3,
              seed=seed, n_hosts=n_hosts, host_id=n_hosts - 1)
    js, ts = jp.ZipfLM(jp.ZipfLMConfig(**kw)), tp.ZipfLM(tp.ZipfLMConfig(**kw))
    for step in (0, 1, 4, 7):
        a, b = js.batch(step), ts.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- MACH maps
@pytest.mark.parametrize("seed,buckets,hashes",
                         [(0, 4096, 1), (3, 1000, 2), (101, 77_777, 3)])
def test_mach_class_hash_matches_reference(seed, buckets, hashes):
    got = t_mach(seed, 50_000, buckets, hashes)
    want = j_mach(seed, 50_000, buckets, hashes)
    assert got.dtype == np.int32 and got.shape == (hashes, 50_000)
    np.testing.assert_array_equal(got, want)


def test_mach_class_hash_chunks(monkeypatch):
    """Hashing in chunks gives the maps of one pass."""
    from repro_torch.core import hashing
    whole = t_mach(9, 10_000, 999, 2)
    monkeypatch.setattr(hashing, "MACH_CHUNK", 777)
    np.testing.assert_array_equal(t_mach(9, 10_000, 999, 2), whole)


def test_class_maps_match_reference():
    cfg_kw = dict(KW, n_meta=3_001, n_replicas=3, seed=4)
    np.testing.assert_array_equal(tx.MachConfig(**cfg_kw).class_maps(),
                                  jx.MachConfig(**cfg_kw).class_maps())
    assert T_CFG.table_shapes() == J_CFG.table_shapes()
    assert tx.TABLE_PATHS == jx.TABLE_PATHS
    assert tx.EXTREME_OPTIMIZERS == jx.EXTREME_OPTIMIZERS
    assert T_CFG.data_config(32).__dict__ == J_CFG.data_config(32).__dict__


def test_meta_stream_maps_labels_and_negatives():
    cmap = T_CFG.class_maps()[1]
    stream = tx.MetaStream(tp.ExtremeStream(T_CFG.data_config(BATCH)), cmap,
                           device="cpu")
    raw = jp.ExtremeStream(J_CFG.data_config(BATCH)).batch(4)
    got = stream.batch(4)
    assert all(v.dtype == torch.int32 for v in got.values())
    np.testing.assert_array_equal(got["features"].numpy(), raw["features"])
    np.testing.assert_array_equal(got["labels"].numpy(), cmap[raw["labels"]])
    np.testing.assert_array_equal(got["negatives"].numpy(),
                                  cmap[raw["negatives"]])


def test_mach_log_scores_match_reference():
    rng = np.random.RandomState(0)
    logits = [rng.randn(5, 300) * s for s in (1.0, 4.0)]
    maps = [rng.randint(0, 300, 2_000) for _ in range(2)]
    cand = rng.randint(0, 2_000, 40)
    np.testing.assert_array_equal(tx.mach_log_scores(logits, maps, cand),
                                  jx.mach_log_scores(logits, maps, cand))


@pytest.mark.parametrize("hi", [3, 50, 10_000])
def test_unique_id_ratio_matches_reference(hi):
    ids = np.random.RandomState(hi).randint(0, hi, 1_000).astype(np.int32)
    got = tx.unique_id_ratio(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(jx.unique_id_ratio(jnp.asarray(ids)))


# ------------------------------------------------------------- dense_rows_adam
def test_dense_rows_adam_matches_reference():
    rng = np.random.RandomState(0)
    n, d = 64, 4
    j_opt = jx.dense_rows_adam(LR, shape=(n, d))
    t_opt = tx.dense_rows_adam(LR, shape=(n, d), device="cpu")
    j_st = j_opt.init()
    t_st = convert.tree_from_numpy(jax.device_get(j_st), "cpu")
    table = rng.randn(n, d).astype(np.float32)
    j_tab, t_tab = jnp.asarray(table), torch.from_numpy(table.copy())
    for _ in range(3):
        ids = rng.randint(0, 10, size=24).astype(np.int32)   # duplicates
        g = rng.randn(24, d).astype(np.float32)
        j_u, j_st = j_opt.update({"ids": jnp.asarray(ids),
                                  "rows": jnp.asarray(g)}, j_st)
        j_tab = JO.apply_sparse_updates(j_tab, j_u)
        t_u, t_st = t_opt.update({"ids": torch.from_numpy(ids),
                                  "rows": torch.from_numpy(g)}, t_st)
        TO.apply_sparse_updates(t_tab, t_u, first_only=True)
        np.testing.assert_allclose(t_u["rows"].numpy(),
                                   np.asarray(j_u["rows"]), **TOL)
        np.testing.assert_allclose(t_tab.numpy(), np.asarray(j_tab), **TOL)
        for k in ("m", "v"):
            np.testing.assert_allclose(t_st[k].numpy(),
                                       np.asarray(j_st[k]), **TOL)
    assert int(t_st["step"]) == 3 and t_st["m"].shape == (n, d)


def test_dense_rows_adam_matches_dense_adam_with_duplicates():
    """The reference's own test: dense Adam in the (ids, rows) convention
    equals full dense Adam on the scatter-added gradient."""
    rng = np.random.RandomState(0)
    n, d = 64, 4
    rows_opt = tx.dense_rows_adam(LR, shape=(n, d), device="cpu")
    dense_opt = TO.adam(LR)
    table_a = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    table_b = {"t": table_a.clone()}
    st_a, st_b = rows_opt.init(), dense_opt.init(table_b)
    ids = rng.randint(0, 10, size=24)
    for _ in range(3):
        g = rng.randn(24, d).astype(np.float32)
        u, st_a = rows_opt.update({"ids": torch.from_numpy(ids).int(),
                                   "rows": torch.from_numpy(g)}, st_a)
        TO.apply_sparse_updates(table_a, u)
        dense_g = np.zeros((n, d), np.float32)
        np.add.at(dense_g, ids, g)
        u_b, st_b = dense_opt.update({"t": torch.from_numpy(dense_g)}, st_b)
        TO.apply_updates(table_b, u_b)
        np.testing.assert_allclose(table_a.numpy(), table_b["t"].numpy(),
                                   atol=1e-5)


# ------------------------------------------------------------- the step
def _batches(n=STEPS, replica=0):
    cmap = T_CFG.class_maps()[replica]
    stream = tx.MetaStream(tp.ExtremeStream(T_CFG.data_config(BATCH)), cmap,
                           device="cpu")
    return [stream.batch(i) for i in range(n)]


def _jax_batch(b):
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _start(j_init, j_opts):
    params = j_init(jax.random.PRNGKey(0))
    state = {p: o.init() for p, o in j_opts.items()}
    return params, state, convert.tree_from_numpy(
        jax.device_get(params), "cpu"), convert.tree_from_numpy(
        jax.device_get(state), "cpu")


def _state_leaves(j_state, t_state):
    for path in j_state:
        for k in ("m", "v"):
            a, b = j_state[path][k], t_state[path][k]
            assert (a is None) == (b is None), (path, k)
            if a is not None:
                yield f"{path}/{k}", np.asarray(a), b.numpy()


@pytest.mark.parametrize("optimizer", ["cs_rmsprop", "cs_adam", "dense_adam"])
def test_trajectory_matches_reference(optimizer):
    j_init, j_step, j_opts = jx.make_extreme_step(J_CFG, optimizer=optimizer,
                                                  lr=LR)
    _, t_step, t_opts = tx.make_extreme_step(T_CFG, optimizer=optimizer,
                                             lr=LR, device="cpu")
    assert list(t_opts) == list(j_opts)
    j_p, j_st, t_p, t_st = _start(j_init, j_opts)
    j_step = jax.jit(j_step)
    metrics = {"loss": [], "grad_norm": [], "dedup_ratio": []}
    for i, b in enumerate(_batches()):
        j_p, j_st, j_m = j_step(j_p, j_st, _jax_batch(b))
        t_p, t_st, t_m = t_step(t_p, t_st, b)
        for k in metrics:
            assert t_m[k].dim() == 0
            metrics[k].append((float(j_m[k]), float(t_m[k])))
        if i == 0 or optimizer == "dense_adam":
            for top in ("tok_embed", "class_head"):
                np.testing.assert_allclose(t_p[top]["table"].numpy(),
                                           np.asarray(j_p[top]["table"]),
                                           **TRAJ_TOL)
    for k, pairs in metrics.items():
        want, got = np.array(pairs).T
        if k == "dedup_ratio":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TRAJ_TOL)
    np.testing.assert_allclose(t_p["class_head"]["table"].numpy(),
                               np.asarray(j_p["class_head"]["table"]),
                               **TRAJ_TOL)
    j_host = jax.device_get(j_st)
    for path in j_host:
        assert int(t_st[path]["step"]) == int(j_host[path]["step"]) == STEPS
    for name, want, got in _state_leaves(j_host, t_st):
        np.testing.assert_allclose(got, want, err_msg=name, **TRAJ_TOL)


def test_gradients_match_reference():
    """One step's loss and (ids, rows) gradients, one row per occurrence,
    against ``jax.value_and_grad`` of the reference's loss."""
    j_init, _, _ = jx.make_extreme_step(J_CFG, lr=LR)
    params = j_init(jax.random.PRNGKey(0))
    t_params = convert.tree_from_numpy(jax.device_get(params), "cpu")
    for b in _batches(3):
        jb = _jax_batch(b)
        emb = params["tok_embed"]["table"][jb["features"]]
        pos = params["class_head"]["table"][jb["labels"]]
        neg = params["class_head"]["table"][jb["negatives"]]
        loss, (g_emb, g_pos, g_neg) = jax.value_and_grad(
            jx._sampled_softmax_loss, argnums=(0, 1, 2))(emb, pos, neg)
        t_loss, grads = tx.extreme_grads(t_params, b)
        np.testing.assert_allclose(float(t_loss), float(loss), **TOL)
        tok, head = grads["tok_embed/table"], grads["class_head/table"]
        np.testing.assert_array_equal(tok["ids"].numpy(),
                                      b["features"].numpy().reshape(-1))
        np.testing.assert_array_equal(
            head["ids"].numpy(), np.concatenate([b["labels"].numpy(),
                                                 b["negatives"].numpy()]))
        np.testing.assert_allclose(tok["rows"].numpy(),
                                   np.asarray(g_emb).reshape(-1, KW["dim"]),
                                   **TOL)
        np.testing.assert_allclose(
            head["rows"].numpy(),
            np.concatenate([np.asarray(g_pos), np.asarray(g_neg)]), **TOL)


@pytest.mark.parametrize("optimizer", ["cs_rmsprop", "cs_adam"])
def test_optimizer_on_reference_gradients(optimizer):
    """The step's optimizer half (``opts`` and ``apply_sparse_updates``)
    fed the reference's gradients each step keeps both tables and every
    state leaf within the trajectory tolerance over 10 steps."""
    j_init, _, j_opts = jx.make_extreme_step(J_CFG, optimizer=optimizer,
                                             lr=LR)
    _, _, t_opts = tx.make_extreme_step(T_CFG, optimizer=optimizer, lr=LR,
                                        device="cpu")
    j_p, j_st, t_p, t_st = _start(j_init, j_opts)

    @jax.jit
    def j_update(params, state, batch):
        feats, labels, negs = (batch["features"], batch["labels"],
                               batch["negatives"])
        emb = params["tok_embed"]["table"][feats]
        _, (g_emb, g_pos, g_neg) = jax.value_and_grad(
            jx._sampled_softmax_loss, argnums=(0, 1, 2))(
            emb, params["class_head"]["table"][labels],
            params["class_head"]["table"][negs])
        grads = {"tok_embed/table": {"ids": feats.reshape(-1),
                                     "rows": g_emb.reshape(-1, KW["dim"])},
                 "class_head/table": {"ids": jnp.concatenate([labels, negs]),
                                      "rows": jnp.concatenate([g_pos,
                                                               g_neg])}}
        new_p, new_st = {"tok_embed": {}, "class_head": {}}, {}
        for path, opt in j_opts.items():
            top, leaf = path.split("/")
            upd, new_st[path] = opt.update(grads[path], state[path])
            new_p[top][leaf] = JO.apply_sparse_updates(params[top][leaf],
                                                       upd)
        return new_p, new_st, grads

    for b in _batches():
        j_p, j_st, grads = j_update(j_p, j_st, _jax_batch(b))
        for path, opt in t_opts.items():
            top, leaf = path.split("/")
            g = {"ids": torch.from_numpy(np.array(grads[path]["ids"])),
                 "rows": torch.from_numpy(np.array(grads[path]["rows"]))}
            upd, t_st[path] = opt.update(g, t_st[path])
            TO.apply_sparse_updates(t_p[top][leaf], upd)
    for top in ("tok_embed", "class_head"):
        np.testing.assert_allclose(t_p[top]["table"].numpy(),
                                   np.asarray(j_p[top]["table"]), **TRAJ_TOL)
    for name, want, got in _state_leaves(jax.device_get(j_st), t_st):
        np.testing.assert_allclose(got, want, err_msg=name, **TRAJ_TOL)


@pytest.mark.parametrize("optimizer", ["cs_rmsprop", "dense_adam"])
def test_step_learns(optimizer):
    """The reference's check: the loss falls over 25 steps of a replica,
    tables and states updated in place."""
    init_fn, step_fn, opts = tx.make_extreme_step(T_CFG, optimizer=optimizer,
                                                  lr=LR, device="cpu")
    params = init_fn(torch.Generator().manual_seed(0))
    table = params["class_head"]["table"]
    state = {p: o.init() for p, o in opts.items()}
    losses = []
    for b in _batches(25, replica=1):
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
    assert params["class_head"]["table"] is table
    assert losses[-1] < losses[0]


def test_extreme_state_round_trips_through_convert():
    j_init, j_step, j_opts = jx.make_extreme_step(J_CFG, optimizer="cs_adam",
                                                  lr=LR)
    params = j_init(jax.random.PRNGKey(1))
    state = {p: o.init() for p, o in j_opts.items()}
    params, state, _ = jax.jit(j_step)(params, state,
                                       _jax_batch(_batches(1)[0]))
    for tree in (jax.device_get(params), jax.device_get(state)):
        back = convert.tree_to_numpy(convert.tree_from_numpy(tree, "cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    rms = jx.make_extreme_step(J_CFG, lr=LR)[2]
    st = convert.tree_from_numpy(
        jax.device_get({p: o.init() for p, o in rms.items()}), "cpu")
    assert st["class_head/table"]["m"] is None
    assert st["class_head/table"]["step"].dtype == torch.int32


# ------------------------------------------------------------- errors
def test_unknown_optimizer_rejected():
    with pytest.raises(ValueError, match="extreme workload"):
        tx.make_extreme_step(T_CFG, optimizer="cs_adam_v", device="cpu")


def test_dense_adam_rejects_plan_and_dp():
    with pytest.raises(ValueError, match="baseline"):
        tx.make_extreme_step(T_CFG, optimizer="dense_adam", plan=object(),
                             device="cpu")
    with pytest.raises(ValueError, match="sketched all-reduce"):
        tx.make_extreme_step(T_CFG, optimizer="dense_adam", dp_axis="data",
                             device="cpu")


def test_unported_modes_raise():
    """Plans are ported (``tests/test_torch_plan.py``): a plan solved for
    another moment layout is refused, as in the reference."""
    with pytest.raises(ValueError, match="moment layout"):
        tx.make_extreme_step(T_CFG, optimizer="cs_adam", device="cpu",
                             plan=tx.plan_extreme(T_CFG, "0.5x"))
    with pytest.raises(ValueError, match="axis named by dp_axis"):
        tx.make_extreme_step(T_CFG, optimizer="cs_adam", mesh=object(),
                             dp_axis="data", device="cpu")
    # a mesh without dp_axis is no data parallelism, as in the reference
    _, _, opts = tx.make_extreme_step(T_CFG, optimizer="cs_adam",
                                      mesh=object(), device="cpu")
    assert all("residual" not in o.init() for o in opts.values())
    # dp_axis is ported (tests/test_torch_dp.py)
    _, _, opts = tx.make_extreme_step(T_CFG, dp_axis="data", device="cpu")
    assert all("residual" in o.init() for o in opts.values())
