"""The port's elastic control plane (``repro_torch.distributed.elastic``)
and placed checkpoints against the JAX package.

* ``plan_resize`` over a grid of surviving-device counts, axes and
  headrooms, field for field, its errors word for word;
* ``recovery_loop`` on scripted failure schedules: the same outcome, the
  same sequence of ``run_steps``/``restore`` calls and failures seen,
  and the same re-raise past ``max_restarts``;
* ``elastic_restore`` of checkpoints the JAX package wrote (f32 and bf16
  sketches; the store-tree, manifest and explicit all-dense predicates;
  fold and no fold), bit-equal to the reference's ``elastic_restore``
  (bf16: to the reference's ``fold_sketches`` of the same arrays, since
  the JAX ``restore`` cannot read bf16 leaves, ROADMAP C);
* ``restore(shardings=)`` and ``elastic_restore(shardings=)``: each
  replica's blocks equal the slices of the global (folded) arrays, and a
  placed ``save`` from ``ReplicaMesh`` threads writes global leaves the
  JAX ``restore`` reads.

The port is given copies of every buffer JAX holds.
"""
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.core import stores as jst
from repro.distributed import elastic as JE
from repro_torch.checkpoint import store as TS
from repro_torch.distributed import ReplicaMesh
from repro_torch.distributed import elastic as TE
from repro_torch.distributed import sharding as shd


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:      # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


GRID = list(itertools.product(
    (0, 1, 3, 7, 8, 15, 16, 17, 100, 240, 255, 256, 512, 1000),
    (1, 2, 4, 16), (1, 4, 16, 32), (1, 2), (0.5, 0.85, 1.0)))


def test_plan_resize_grid():
    for chips, model, old, pods, head in GRID:
        kw = dict(model_axis=model, old_data_axis=old, pods=pods,
                  memory_headroom=head)
        j, t = _outcome(JE.plan_resize, chips, **kw), \
            _outcome(TE.plan_resize, chips, **kw)
        if j[0] == "ok":
            assert t[0] == "ok"
            for f in ("data_axis", "model_axis", "pods", "fold_sketch",
                      "chips"):
                assert getattr(t[1], f) == getattr(j[1], f), (chips, kw, f)
        else:
            assert t == j, (chips, kw)
    assert TE.plan_resize(3, model_axis=1, old_data_axis=4) == \
        TE.ElasticPlan(data_axis=2, model_axis=1, pods=1, fold_sketch=True)
    for n in range(0, 70):
        assert TE.largest_pow2_leq(n) == JE.largest_pow2_leq(n)


SCHEDULES = [
    ((), 10, 10),                     # no failure
    ((5,), 10, 10),                   # one failure after a checkpoint at 4
    ((3, 3, 7), 10, 10),              # the same step fails twice
    ((1, 2, 3, 4, 5, 6), 10, 3),      # more failures than restarts
    ((0,), 1, 10),
]


def _scripted(failures, ckpt_every=4):
    """run_steps/restore over a scripted schedule of failing steps (each
    fails once); the calls are logged."""
    log, pending, ckpt = [], list(failures), {"step": 0}

    def restore():
        log.append(("restore", ckpt["step"]))
        return ckpt["step"]

    def run_steps(start, total):
        log.append(("run", start, total))
        for s in range(start, total):
            if pending and s == pending[0]:
                pending.pop(0)
                raise RuntimeError(f"failure at {s}")
            if (s + 1) % ckpt_every == 0:
                ckpt["step"] = s + 1
        return total

    return run_steps, restore, log


@pytest.mark.parametrize("failures,total,max_restarts", SCHEDULES)
def test_recovery_loop_schedules(failures, total, max_restarts):
    outs = []
    for mod in (JE, TE):
        run, restore, log = _scripted(failures)
        seen = []
        out = _outcome(mod.recovery_loop, run, restore, total_steps=total,
                       max_restarts=max_restarts,
                       on_failure=lambda e: seen.append(str(e)))
        if out[0] == "ok":
            out = ("ok", (out[1].steps_run, out[1].restarts,
                          out[1].final_step))
        outs.append((out, log, seen))
    assert outs[0] == outs[1]


def _tree():
    return jst.StoreTree(rules=(
        ("tok_embed/table",
         jst.CountSketchStore(compression=4.0, width_multiple=16).bind(
             "tok_embed/table", (1024, 8), jnp.float32),
         jst.CountMinStore(compression=4.0, width_multiple=16).bind(
             "tok_embed/table", (1024, 8), jnp.float32)),),
        default_m=jst.DenseStore(), default_v=jst.DenseStore())


def _state(dtype):
    rng = np.random.RandomState(0)
    m_store, v_store = _tree().resolve("tok_embed/table", (1024, 8),
                                       jnp.float32)
    return {
        "params": {"tok_embed": {"table": rng.randn(1024, 8).astype(
            np.float32)}, "ln": {"scale": rng.randn(8).astype(np.float32)}},
        "opt_state": {
            "step": np.asarray(7, np.int32),
            "m": {"tok_embed": {"table": rng.randn(
                *m_store.spec.shape).astype(dtype)},
                "ln": {"scale": rng.randn(8).astype(np.float32)}},
            "v": {"tok_embed": {"table": rng.rand(
                *v_store.spec.shape).astype(dtype)},
                "ln": {"scale": rng.rand(8).astype(np.float32)}},
        },
    }


def _like(state):
    return {"params": {"tok_embed": {"table": 0}, "ln": {"scale": 0}},
            "opt_state": {"step": 0, "m": {"tok_embed": {"table": 0},
                                           "ln": {"scale": 0}},
                          "v": {"tok_embed": {"table": 0},
                                "ln": {"scale": 0}}}}


def _np(tree):
    out = {}
    for path, leaf in TS._flatten(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            else:
                leaf = leaf.numpy()
        out[path] = np.asarray(leaf)
    return out


def _jnp(tree):
    return {p: np.asarray(v) for p, v in JS._flatten(tree)[0]}


PREDICATES = ["manifest", "store_tree", "dense_tree"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pred", PREDICATES)
@pytest.mark.parametrize("fold", [True, False])
def test_elastic_restore_of_jax_checkpoints(tmp_path, dtype, pred, fold):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    state = _state(np_dtype)
    JS.save(tmp_path, 7, {k: jnp.asarray(v) if not isinstance(v, dict)
                          else v for k, v in state.items()},
            extra={"store_tree": _tree().to_json()})
    plan = TE.ElasticPlan(data_axis=8, model_axis=16, pods=1,
                          fold_sketch=fold)
    jplan = JE.ElasticPlan(data_axis=8, model_axis=16, pods=1,
                           fold_sketch=fold)
    kw, tkw = {}, {}
    if pred == "store_tree":
        kw["store_tree"] = _tree()
        from repro_torch.core.stores import StoreTree
        tkw["store_tree"] = StoreTree.from_json(_tree().to_json())
    elif pred == "dense_tree":
        kw["store_tree"] = jst.StoreTree(rules=(),
                                         default_m=jst.DenseStore(),
                                         default_v=jst.DenseStore())
        from repro_torch.core.stores import DenseStore, StoreTree
        tkw["store_tree"] = StoreTree(rules=(), default_m=DenseStore(),
                                      default_v=DenseStore())
    tstep, ttree, tfolded = TE.elastic_restore(tmp_path, _like(state), plan,
                                               device="cpu", **tkw)
    got = _np(ttree)
    if dtype == "float32":
        jstep, jtree, jfolded = JE.elastic_restore(tmp_path, _like(state),
                                                   jplan, **kw)
        want = _jnp(jtree)
    else:   # the JAX restore cannot read bf16 leaves: fold the arrays
        jstep, jfolded = 7, fold
        jtree = {k: v for k, v in state.items()}
        if fold:
            p = (JS.is_sketch_from_store_tree(kw["store_tree"])
                 if kw else JS.fold_predicate_from_manifest(
                     JS.read_manifest(tmp_path)))
            jtree = JS.fold_sketches(jtree, p)
        want = _jnp(jtree)
    assert (tstep, tfolded) == (jstep, jfolded)
    assert set(got) == set(want)
    for p in want:
        assert got[p].dtype == want[p].dtype and got[p].shape == \
            want[p].shape, p
        np.testing.assert_array_equal(
            got[p].reshape(-1).view(np.uint8),
            np.asarray(want[p]).reshape(-1).view(np.uint8), p)
    halved = got["opt_state/v/tok_embed/table"].shape[1] * 2 == \
        state["opt_state"]["v"]["tok_embed"]["table"].shape[1]
    assert halved == (fold and pred != "dense_tree")


def test_elastic_restore_names_a_bare_one_table_state(tmp_path):
    """A one-table sparse state keeps bare ``m``/``v`` leaves no StoreTree
    rule path names, so the manifest predicate folds nothing there (as in
    the reference); ``is_sketch`` names them."""
    rng = np.random.RandomState(1)
    state = {"params": rng.randn(64, 4).astype(np.float32),
             "opt_state": {"step": np.asarray(3, np.int32),
                           "m": rng.randn(3, 32, 4).astype(np.float32),
                           "v": rng.rand(3, 32, 4).astype(np.float32)}}
    JS.save(tmp_path, 3, state, extra={"store_tree": _tree().to_json()})
    like = {"params": 0, "opt_state": {"step": 0, "m": 0, "v": 0}}
    plan = TE.plan_resize(3, model_axis=1, old_data_axis=4)
    _, jt, _ = JE.elastic_restore(tmp_path, like, JE.plan_resize(
        3, model_axis=1, old_data_axis=4))
    _, tt, folded = TE.elastic_restore(tmp_path, like, plan, device="cpu")
    assert folded and tt["opt_state"]["v"].shape == (3, 32, 4) == \
        jt["opt_state"]["v"].shape
    _, tt, _ = TE.elastic_restore(
        tmp_path, like, plan, device="cpu",
        is_sketch=lambda p, _l: p in ("opt_state/m", "opt_state/v"))
    v = state["opt_state"]["v"]
    np.testing.assert_array_equal(tt["opt_state"]["v"].numpy(),
                                  v[:, :16] + v[:, 16:])
    np.testing.assert_array_equal(tt["params"].numpy(), state["params"])


@pytest.mark.parametrize("grid", [(1, 4), (2, 2), (4, 1)])
def test_placed_restore_blocks_are_slices(tmp_path, grid):
    state = _state(np.float32)
    JS.save(tmp_path, 7, state, extra={"store_tree": _tree().to_json()})
    mesh = shd.Grid(grid)
    like = _like(state)
    specs = {"params": {"tok_embed": {"table": ("data",)},
                        "ln": {"scale": ()}},
             "opt_state": {"step": (), "m": {"tok_embed": {"table": (
                 None, "model")}, "ln": {"scale": ("model",)}},
                 "v": {"tok_embed": {"table": (None, ("data", "model"))},
                       "ln": {"scale": None}}}}
    v = state["opt_state"]["v"]["tok_embed"]["table"]
    for rank in range(mesh.size):
        d, s = mesh.coords(rank)
        pl = shd.Placement(specs, mesh, (d, s))
        _, tree = TS.restore(tmp_path, like, device="cpu", shardings=pl)
        t = state["params"]["tok_embed"]["table"]
        n = t.shape[0] // grid[0]
        np.testing.assert_array_equal(tree["params"]["tok_embed"]["table"],
                                      t[d * n:(d + 1) * n])
        m = state["opt_state"]["m"]["tok_embed"]["table"]
        lw = m.shape[1] // grid[1]
        np.testing.assert_array_equal(
            tree["opt_state"]["m"]["tok_embed"]["table"],
            m[:, s * lw:(s + 1) * lw])
        lw = v.shape[1] // (grid[0] * grid[1])
        np.testing.assert_array_equal(
            tree["opt_state"]["v"]["tok_embed"]["table"],
            v[:, rank * lw:(rank + 1) * lw])
        sc = state["opt_state"]["m"]["ln"]["scale"]
        np.testing.assert_array_equal(tree["opt_state"]["m"]["ln"]["scale"],
                                      sc[s * (8 // grid[1]):
                                         (s + 1) * (8 // grid[1])])
        assert int(tree["opt_state"]["step"]) == 7
        # elastic: the global leaf folded, then this replica's block
        _, etree, _ = TE.elastic_restore(
            tmp_path, like, TE.ElasticPlan(2, 1, 1, True), device="cpu",
            shardings=pl)
        vf = v[:, : v.shape[1] // 2] + v[:, v.shape[1] // 2:]
        lw = vf.shape[1] // (grid[0] * grid[1])
        np.testing.assert_array_equal(
            etree["opt_state"]["v"]["tok_embed"]["table"],
            vf[:, rank * lw:(rank + 1) * lw])


def test_placed_save_writes_global_leaves(tmp_path):
    """Four ``ReplicaMesh`` threads save their slabs: the origin writes
    the gathered global leaves (the JAX restore reads them), and a
    restore onto a 1 x 2 grid gives each replica its block."""
    rng = np.random.RandomState(2)
    full = {"params": rng.randn(16, 4).astype(np.float32),
            "opt_state": {"step": np.asarray(5, np.int32),
                          "m": rng.randn(3, 32, 4).astype(np.float32),
                          "v": rng.rand(3, 32, 4).astype(np.float32)}}
    mesh = ReplicaMesh((1, 4), timeout=60)
    like = {"params": 0, "opt_state": {"step": 0, "m": 0, "v": 0}}
    specs = {"params": (), "opt_state": {"step": (), "m": (None, "model"),
                                         "v": (None, "model")}}

    def replica(async_):
        pl = shd.Placement(specs, mesh)
        tree = {"params": torch.from_numpy(full["params"].copy()),
                "opt_state": shd.place({k: torch.from_numpy(
                    np.array(v)) for k, v in full["opt_state"].items()},
                    shd.Placement(specs["opt_state"], mesh), "cpu")}
        assert tree["opt_state"]["v"].shape == (3, 8, 4)
        out = TS.save(tmp_path / str(async_), 5, tree, async_=async_,
                      shardings=pl)
        if async_:
            out.join()
        else:
            assert out is None
        return True

    for async_ in (False, True):
        assert mesh.run(replica, [(async_,)] * 4) == [True] * 4
        step, jtree = JS.restore(tmp_path / str(async_), like)
        assert step == 5
        for k in ("m", "v"):
            np.testing.assert_array_equal(np.asarray(jtree["opt_state"][k]),
                                          full["opt_state"][k])
    half = ReplicaMesh((1, 2), timeout=60)

    def reread():
        _, tree = TS.restore(tmp_path / "True", like, device="cpu",
                             shardings=shd.Placement(specs, half))
        return tree["opt_state"]["v"]

    v = full["opt_state"]["v"]
    got = half.run(reread, [()] * 2)
    for s in range(2):
        np.testing.assert_array_equal(got[s].numpy(),
                                      v[:, s * 16:(s + 1) * 16])
