"""The port's memory planner against the JAX package's.

The planner is host code over integers and Python floats, so it is held
with no tolerance: ``for_budget`` and ``SketchSpec.fold`` give the same
specs (and the same errors), the error model the same floats, and
``plan_for_params``/``plan_for_tables`` the same ``Plan.to_json()`` dict
over the reference's own grid (``tests/test_plan.py``'s budgets and zipf
exponents, the three moment modes, f32/bf16/int8 cells, one and two
sketch shards).  ``measure_aux_bytes`` of the port's real state equals
the plan's prediction; JSON written by the JAX package loads into the
port and serialises back to the same dict.  The planned extreme step is
held to the reference's ``make_extreme_step(plan=)`` under
``tests/test_torch_extreme.py``'s tolerances and its rule for the
sketched feature table.  Torch runs on one CPU thread.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.core import hashing as JH
from repro.core import sketch as JS
from repro.core import stores as JST
from repro.core.cleaning import CleaningSchedule as JClean
from repro.plan import error_model as JE
from repro.train import extreme as jx
from repro_torch import convert
from repro_torch import plan as TP
from repro_torch.core import sketch as TS
from repro_torch.core import stores as TST
from repro_torch.plan import error_model as TE
from repro_torch.train import extreme as tx

torch.set_num_threads(1)

PK = dict(width_multiple=16)
BUDGET_FRACS = ("floor", 0.2, 0.35, 0.6, 0.9, 1.0, 1.4)   # tests/test_plan.py
ALPHAS = (0.8, 1.1, 1.5)
MODES = {"cs_adam": (True, True), "cs_adam_v": (True, False),
         "cs_rmsprop": (False, False)}
DTYPES = ("float32", "bfloat16", "int8")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _shapes(n=4096, d=32):
    return {"tok_embed": {"table": (n, d)}, "lm_head": {"table": (n // 2, d)},
            "w": (64, 64), "head": {"proj": (4, d)}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _pair(shapes):
    """(reference zeros, port zeros) of one shape tree."""
    return (_map(shapes, lambda s: jnp.zeros(s)),
            _map(shapes, lambda s: torch.zeros(s)))


# ------------------------------------------------------------- for_budget
def _spec_tuple(spec):
    return (spec.depth, spec.width, spec.dim, spec.signed, spec.seed,
            np.dtype(spec.dtype).name if not isinstance(spec.dtype, str)
            else spec.dtype, spec.identity, spec.shards, spec.layout,
            spec.scale_block, spec.nbytes())


def _outcome(fn):
    try:
        return _spec_tuple(fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("dtype", DTYPES)
def test_for_budget_matches_reference(dtype):
    for shape in ((4096, 32), (100, 8), (1 << 16, 16), (5000, 7)):
        for nbytes in (100, 10_000, 50_000, 1_000_000, 10**9, 6_291_456,
                       3 * 256 * 16 + 3 * 4):
            for wm in (16, 256):
                for depth in (1, 3):
                    kw = dict(depth=depth, width_multiple=wm, seed=7,
                              signed=False)
                    want = _outcome(lambda: JS.for_budget(
                        shape, nbytes, dtype=jnp.dtype(dtype), **kw))
                    got = _outcome(lambda: TS.for_budget(
                        shape, nbytes, dtype=dtype, **kw))
                    if want[0] != "ValueError":
                        want = want[:5] + (dtype,) + want[6:]
                    assert got == want, (shape, nbytes, wm, depth)


def test_for_budget_rejects_rank_other_than_two():
    with pytest.raises(ValueError, match="rank-2"):
        TS.for_budget((10,), 10**6)


@pytest.mark.parametrize("width,shards", [(512, 1), (1024, 2), (96, 4)])
def test_spec_fold_matches_reference(width, shards):
    kw = dict(depth=3, width=width, dim=8, seed=5, shards=shards)
    j = JS.SketchSpec(**kw).fold()
    t = TS.SketchSpec(**kw).fold()
    assert (t.width, t.shards, t.layout) == (j.width, j.shards, j.layout)
    fam = TS.SketchSpec(**kw).family
    ids = np.random.RandomState(width).randint(0, 1 << 20, 4096
                                               ).astype(np.int32)
    # the folded family buckets as h mod (w/2), the reference's and the
    # unfolded family's buckets taken mod the new width
    got = fam.fold().bucket(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JH.HashFamily(seed=5, depth=3, width=width,
                                      shards=shards).fold().bucket(
            jnp.asarray(ids))))
    np.testing.assert_array_equal(
        got, fam.bucket(torch.from_numpy(ids)).numpy() % (width // 2))


def test_fold_errors():
    with pytest.raises(ValueError, match="even"):
        TS.SketchSpec(depth=3, width=6 * 64 + 1, dim=4).fold()
    with pytest.raises(ValueError, match="shard"):
        TS.SketchSpec(depth=3, width=6, dim=4, shards=6).fold()
    # the hash layout folds per slab, as the reference's does
    got = TS.SketchSpec(depth=3, width=64, dim=4, shards=2,
                        layout="hash").fold()
    want = JS.SketchSpec(depth=3, width=64, dim=4, shards=2,
                         layout="hash").fold()
    assert TST.spec_to_json(got) == JST.spec_to_json(want)
    with pytest.raises(ValueError, match="shard"):
        TS.SketchSpec(depth=3, width=12, dim=4, shards=4,
                      layout="hash").fold()


def test_folded_state_is_the_half_width_sketch():
    """``S[:, :w/2] + S[:, w/2:]`` equals the sketch written directly at
    the folded spec (``tests/test_sketch.py``'s check, on the port)."""
    spec = TS.for_param((256, 8), compression=2.0, width_multiple=8, seed=3)
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(0, 256, 300).astype(np.int32))
    delta = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    S = TS.update(spec, TS.init(spec, "cpu"), ids, delta)
    half = spec.width // 2
    direct = TS.update(spec.fold(), TS.init(spec.fold(), "cpu"), ids, delta)
    torch.testing.assert_close(S[:, :half] + S[:, half:], direct,
                               rtol=0, atol=1e-5)


# ------------------------------------------------------------- error model
def test_error_model_exact():
    for st_kw in (dict(alpha=0.8), dict(alpha=1.0), dict(alpha=1.5),
                  dict(alpha=1.1, weight=3.0)):
        j, t = JE.TableStats(**st_kw), TE.TableStats(**st_kw)
        for n in (1, 100, 5_000, 100_000, 100_001, 2_097_152, 49_500_000):
            assert t.herfindahl(n) == j.herfindahl(n)
            for w, dep in ((16, 1), (256, 3), (5376, 3), (10**6, 5)):
                assert TE.countmin_error(t, n, w, dep) == \
                    JE.countmin_error(j, n, w, dep)
                assert TE.countsketch_error(t, n, w, dep) == \
                    JE.countsketch_error(j, n, w, dep)
            assert TE.rank1_error(t, n) == JE.rank1_error(j, n)
    for a in (0.8, 1.0, 1.2):
        for n in (7, 100_000, 3_000_000):
            assert TE.zipf_power_sum(n, a) == JE.zipf_power_sum(n, a)
    batches = [{"tokens": np.array([[0, 0, 1], [2, 0, 1]])},
               {"tokens": np.array([4, 4, 9])}]
    counts = TE.measure_freqs(batches, 6)
    np.testing.assert_array_equal(counts, JE.measure_freqs(batches, 6))
    assert TE.TableStats(freqs=counts).herfindahl(6) == \
        JE.TableStats(freqs=counts).herfindahl(6)
    assert TE.TableStats(freqs=np.zeros(4)).herfindahl(4) == 0.25


# ------------------------------------------------------------- candidates
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_leaf_candidates_match_reference(mode, dtype):
    track, first = MODES[mode]
    for path, shape, stats in (
            ("tok_embed/table", (4096, 32), None),
            ("tok_embed/table", (4096, 512), (1.1,)),
            ("w", (4096, 32), (0.8,)),
            ("w", (4096, 32), None),
            ("lm_head/table", (1000, 32), None)):
        kw = dict(depth=3, width_multiple=16, sketch_dtype=dtype,
                  track_first_moment=track, sketch_first_moment=first)
        want = JP.leaf_candidates(
            path, shape, jnp.float32,
            stats=None if stats is None else JE.TableStats(alpha=stats[0]),
            **kw)
        got = TP.leaf_candidates(
            path, shape, torch.float32,
            stats=None if stats is None else TE.TableStats(alpha=stats[0]),
            **kw)
        assert [dataclasses.astuple(c) for c in got] == \
            [dataclasses.astuple(c) for c in want], (path, shape)


# ------------------------------------------------------------- the grid
def _budget(frac, dense, floor):
    return floor if frac == "floor" else int(frac * dense)


def _solve(pkg, params, frac, alpha, track, first, dtype, shards):
    kw = dict(default_alpha=alpha, track_first_moment=track,
              sketch_first_moment=first, sketch_dtype=dtype, **PK)
    dense = pkg.dense_budget_bytes(params, track_first_moment=track)
    floor = pkg.min_budget_bytes(params, shards=shards, **kw)
    budget = _budget(frac, dense, floor)
    try:
        return pkg.plan_for_params(params, budget, shards=shards, **kw)
    except pkg.InfeasibleBudgetError as e:
        return ("infeasible", e.budget, e.floor)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("frac", BUDGET_FRACS)
def test_plans_equal_reference_over_grid(frac, alpha):
    """Every plan of the grid equals the reference's as JSON; the port's
    real state measures the predicted bytes."""
    solved = 0
    for d in (32, 512):
        j_params, t_params = _pair(_shapes(d=d))
        for mode, (track, first) in MODES.items():
            for dtype in DTYPES:
                for shards in (1, 2):
                    if dtype == "int8" and shards > 1:
                        continue        # int8 cells do not shard (either)
                    case = (d, mode, dtype, shards)
                    want = _solve(JP, j_params, frac, alpha, track, first,
                                  dtype, shards)
                    got = _solve(TP, t_params, frac, alpha, track, first,
                                 dtype, shards)
                    if isinstance(want, tuple):
                        assert got == want, case
                        continue
                    assert got.to_json() == want.to_json(), case
                    assert TP.Plan.from_json(got.to_json()) == got
                    solved += 1
                    if shards > 1:
                        assert got.predicted_aux_bytes_per_device == \
                            want.predicted_aux_bytes_per_device
                        assert got.shard_table() == want.shard_table()
                        continue
                    state = got.make_optimizer(1e-3).init(t_params)
                    assert TP.measure_aux_bytes(state) == \
                        got.predicted_aux_bytes, case
                    assert got.table() == want.table()
    assert solved


@pytest.mark.parametrize("mode", sorted(MODES))
def test_min_budget_and_predicted_policy_bytes(mode):
    from repro.core import optimizers as JO
    from repro.core.partition import SketchPolicy as JSP
    from repro_torch.core import optimizers as TO
    from repro_torch.core.partition import SketchPolicy as TSP
    track, first = MODES[mode]
    j_params, t_params = _pair(_shapes(d=512))
    for alpha in ALPHAS:
        kw = dict(default_alpha=alpha, track_first_moment=track,
                  sketch_first_moment=first, **PK)
        assert TP.min_budget_bytes(t_params, **kw) == \
            JP.min_budget_bytes(j_params, **kw)
    kw = dict(track_first_moment=track, sketch_first_moment=first)
    rank1 = (lambda p, s: p == "tok_embed/table") if track else \
        (lambda p, s: False)
    want = JP.predict_policy_bytes(
        j_params, policy=JSP(), rank1_policy=rank1,
        hparams=JO.SketchHParams(width_multiple=16), **kw)
    got = TP.predict_policy_bytes(
        t_params, policy=TSP(), rank1_policy=rank1,
        hparams=TO.SketchHParams(width_multiple=16), **kw)
    assert got == want
    assert TP.dense_budget_bytes(t_params, track_first_moment=track) == \
        JP.dense_budget_bytes(j_params, track_first_moment=track)


TABLES = {"class_head/table": (1 << 20, 16), "tok_embed/table": (1 << 14, 16)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_for_tables_matches_reference(mode, dtype):
    """The reference's ``TestPlanForTables`` shapes; bytes measured on the
    ``meta`` device (the optimizer's real init, nothing allocated)."""
    for budget in ("0.05x", "floor", "0.5x", 3_000_000):
        for shards in ((1, 2) if dtype != "int8" else (1,)):
            kw = dict(optimizer=mode, sketch_dtype=dtype, shards=shards,
                      stats={p: JE.TableStats(alpha=1.05) for p in TABLES})
            try:
                want = JP.plan_for_tables(TABLES, budget, **kw).to_json()
            except JP.InfeasibleBudgetError as e:
                want = ("infeasible", e.floor)
            kw["stats"] = {p: TE.TableStats(alpha=1.05) for p in TABLES}
            try:
                plan = TP.plan_for_tables(TABLES, budget, **kw)
                got = plan.to_json()
            except TP.InfeasibleBudgetError as e:
                got, plan = ("infeasible", e.floor), None
            assert got == want, (budget, shards)
            if plan is not None:
                state = plan.make_optimizer(1e-3).init(
                    TP.accounting.meta_params(
                        {p: TP.ShapeDtype(s) for p, s in TABLES.items()}))
                assert TP.measure_aux_bytes(state) == \
                    plan.predicted_aux_bytes


def test_plan_errors_match_reference():
    with pytest.raises(ValueError, match="moment layouts"):
        TP.plan_for_tables(TABLES, "0.5x", optimizer="dense_adam")
    with pytest.raises(TP.InfeasibleBudgetError):
        TP.plan_for_tables(TABLES, 1024)
    with pytest.raises(ValueError, match="divisible"):
        TP.plan_for_params(_pair(_shapes())[1], 10**9, width_multiple=16,
                           shards=3)
    # a sharded plan executes: its StoreTree is the reference's, and its
    # optimizer's state the full tensors, as the reference's is
    plan = TP.plan_for_tables(TABLES, "0.05x").with_sharding(2)
    jplan = JP.plan_for_tables(TABLES, "0.05x").with_sharding(2)
    assert plan.store_tree().to_json() == jplan.store_tree().to_json()
    shapes = {p: TP.ShapeDtype(s) for p, s in TABLES.items()}
    state = plan.make_optimizer(1e-3).init(
        TP.accounting.meta_params(shapes))
    j_state = jax.eval_shape(jplan.make_optimizer(1e-3).init, {
        p: jax.ShapeDtypeStruct(s, jnp.float32) for p, s in TABLES.items()})
    for moment in ("m", "v"):
        for path in TABLES:
            got, want = state[moment][path], j_state[moment][path]
            assert (got is None) == (want is None)
            assert got is None or tuple(got.shape) == tuple(want.shape)
    assert TP.measure_aux_bytes(state) == plan.predicted_aux_bytes
    # every registry model plans: rwkv6-7b's plan JSON equals the
    # reference's, at its floor and at its 57 GB config budget
    from repro import configs as jconfigs
    from repro.plan import cli as jcli
    from repro_torch import configs
    from repro_torch.plan import cli
    rwkv = configs.get("rwkv6_7b")
    assert rwkv.aux_budget_bytes == 57_000_000_000
    ps = cli.params_shapes_for_config(rwkv)
    assert sum(x.numel() for x in jax.tree_util.tree_leaves(ps)) == \
        7_534_546_944
    assert all(x.device.type == "meta"
               for x in jax.tree_util.tree_leaves(ps))
    for budget in ("floor", "config"):
        got = cli.plan_for_config(rwkv, budget)
        want = jcli.plan_for_config(jconfigs.get("rwkv6_7b"), budget)
        assert got.to_json() == want.to_json()
    for text, want in (("0.25x", 250), ("floor", 7), ("512MiB", 512 << 20),
                       ("8.6GB", 8_600_000_000), ("123", 123)):
        assert TP.parse_budget(text, dense_bytes=1000, floor_bytes=7) == \
            JP.parse_budget(text, dense_bytes=1000, floor_bytes=7) == want


def test_plan_fold_and_specs_match_reference():
    j_params, t_params = _pair(_shapes())
    for track, first in MODES.values():
        kw = dict(track_first_moment=track, sketch_first_moment=first, **PK)
        budget = max(JP.min_budget_bytes(j_params, **kw), int(
            0.35 * JP.dense_budget_bytes(j_params, track_first_moment=track)))
        j = JP.plan_for_params(j_params, budget, **kw)
        t = TP.plan_for_params(t_params, budget, **kw)
        assert t.fold().to_json() == j.fold().to_json()
        for path, d in t.specs().items():
            for moment, spec in d.items():
                want = j.specs()[path][moment]
                assert TST.spec_to_json(spec) == JST.spec_to_json(want)
                assert spec.fold() == t.fold().specs()[path][moment]
        state = t.make_optimizer(1e-3).init(t_params)
        for path, d in t.specs().items():
            top, leaf = path.split("/")
            assert tuple(state["v"][top][leaf].shape) == d["v"].shape


# ------------------------------------------------------------- JSON
def _store_trees():
    """StoreTrees the JAX package writes: planned (with cleaning, a
    backend, rank-1 leaves, int8 cells), sharded, and factory stores."""
    j_params = _pair(_shapes(d=512))[0]
    out = []
    for kw in (dict(), dict(sketch_first_moment=False),
               dict(track_first_moment=False, sketch_dtype="int8")):
        plan = JP.plan_for_params(j_params, JP.min_budget_bytes(
            j_params, **PK, **kw), **PK, **kw)
        out.append(plan.store_tree().to_json())
        out.append(plan.with_backend("tiled").store_tree(
            cleaning=JClean(alpha=0.5, every=10, mode="async")).to_json())
    sharded = JP.plan_for_params(j_params, 10**6, **PK).with_sharding(
        2, "hash")
    out.append(sharded.store_tree(cleaning=JClean()).to_json())
    out.append(JST.StoreTree(
        rules=(("a", JST.CountSketchStore(compression=3.0, width=None,
                                          identity=True, seed=4),
                JST.CountMinStore(width=512, dtype="bfloat16",
                                  shards=2, shard_layout="hash")),
               ("b", None, JST.Rank1Store()),
               ("c", JST.DenseStore(dtype="bfloat16", shape=(3, 4)),
                JST.CountMinStore(spec=JS.SketchSpec(
                    depth=2, width=512, dim=4, signed=False, seed=9,
                    dtype=jnp.int8, scale_block=128), shape=(4096, 4)))),
        default_m=None).to_json())
    return out


@pytest.mark.parametrize("i", range(8))
def test_store_tree_json_round_trips_through_the_port(i):
    d = json.loads(json.dumps(_store_trees()[i]))
    tree = TST.StoreTree.from_json(d)
    assert tree.to_json() == d
    assert JST.StoreTree.from_json(tree.to_json()).to_json() == d


def test_plan_json_round_trips_through_the_port():
    j_params = _pair(_shapes(d=512))[0]
    plans = [JP.plan_for_params(j_params, int(f * JP.dense_budget_bytes(
        j_params)), sketch_dtype=dt, **PK)
        for f, dt in ((0.35, "float32"), (0.2, "int8"), (1.0, "bfloat16"))]
    plans.append(plans[0].with_sharding(2, "hash").with_backend("tiled"))
    plans.append(JP.plan_for_params(j_params, JP.min_budget_bytes(
        j_params, sketch_first_moment=False, **PK),
        sketch_first_moment=False, **PK))
    for jplan in plans:
        d = json.loads(json.dumps(jplan.to_json()))
        tplan = TP.Plan.from_json(d)
        assert tplan.to_json() == d
        assert tplan.table() == jplan.table()
        assert tplan.store_tree().to_json() == jplan.store_tree().to_json()


def test_port_specs_serialise_as_the_reference():
    for kw in (dict(), dict(dtype="bfloat16"), dict(dtype="int8"),
               dict(dtype="int8", scale_block=64), dict(shards=4),
               dict(shards=2, layout="hash"), dict(identity=True)):
        t = TS.SketchSpec(depth=3, width=1024, dim=8, seed=11, **kw)
        jkw = dict(kw)
        if "dtype" in jkw:
            jkw["dtype"] = jnp.dtype(jkw["dtype"])
        j = JS.SketchSpec(depth=3, width=1024, dim=8, seed=11, **jkw)
        assert TST.spec_to_json(t) == JST.spec_to_json(j)
        assert TST.spec_from_json(TST.spec_to_json(t)) == t
    for bind in (False, True):
        t, j = TST.CountMinStore(width=512), JST.CountMinStore(width=512)
        if bind:
            t, j = t.bind("x", (4096, 8)), j.bind("x", (4096, 8), jnp.float32)
        t, j = t.with_sharding(2, "hash"), j.with_sharding(2, "hash")
        d = TST.store_to_json(t)
        assert d == JST.store_to_json(j)
        assert TST.store_to_json(TST.store_from_json(d)) == d
        assert (t.shards, t.shard_layout) == (2, "hash")
        if bind:
            assert (t.spec.shards, t.spec.layout) == (2, "hash")


# ------------------------------------------------------------- the configs
# the planned cells chip_smoke.py phase 9 runs
EXTREME_KW = dict(n_classes=8_000_000, n_meta=1 << 21, n_features=1 << 16,
                  dim=64, nnz=16, n_negatives=1_024)
SOFTMAX = {"tok_embed": {"table": (151_936, 896)}, "final_norm": {"scale": (896,)}}


def test_planned_cells_match_reference():
    want = jx.plan_extreme(jx.MachConfig(**EXTREME_KW), 5_701_632)
    got = tx.plan_extreme(tx.MachConfig(**EXTREME_KW), 5_701_632,
                          backend="auto")
    assert got.with_backend(None).to_json() == want.to_json()
    assert got.backend == "auto" and got.predicted_aux_bytes == 5_701_632
    assert {l.path: (l.depth, l.width) for l in got.leaves} == {
        "class_head/table": (3, 5_376), "tok_embed/table": (3, 2_048)}
    j_ps = _map(SOFTMAX, lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    t_ps = _map(SOFTMAX, lambda s: TP.ShapeDtype(s))
    for budget, width in ((220_208_128, 10_240), (200_000_000, 9_216)):
        got = TP.plan_for_params(t_ps, budget)
        assert got.to_json() == JP.plan_for_params(j_ps, budget).to_json()
        assert got.leaf("tok_embed/table").width == width
    floor = TP.min_budget_bytes(t_ps, sketch_first_moment=False)
    got = TP.plan_for_params(t_ps, floor, sketch_first_moment=False)
    assert got.to_json() == JP.plan_for_params(
        j_ps, floor, sketch_first_moment=False).to_json()
    leaf = got.leaf("tok_embed/table")
    assert (leaf.mode, leaf.bytes_v) == ("rank1", (151_936 + 896) * 4)


# ------------------------------------------------------------- extreme step
KW = dict(n_classes=50_000, n_meta=4096, n_features=2048, dim=16, nnz=8,
          n_negatives=64)
J_CFG, T_CFG = jx.MachConfig(**KW), tx.MachConfig(**KW)
BATCH, LR, STEPS = 32, 1e-2, 10


@pytest.mark.parametrize("optimizer,budget", [("cs_rmsprop", "0.5x"),
                                              ("cs_adam", 300_000)])
def test_planned_extreme_step_matches_reference(optimizer, budget):
    jplan = jx.plan_extreme(J_CFG, budget, optimizer=optimizer)
    tplan = tx.plan_extreme(T_CFG, budget, optimizer=optimizer)
    assert tplan.to_json() == jplan.to_json()
    assert {l.mode for l in tplan.leaves} == {"sketch"}
    j_init, j_step, j_opts = jx.make_extreme_step(
        J_CFG, optimizer=optimizer, lr=LR, plan=jplan)
    _, t_step, t_opts = tx.make_extreme_step(
        T_CFG, optimizer=optimizer, lr=LR, plan=tplan, device="cpu")
    j_p = j_init(jax.random.PRNGKey(0))
    j_st = {p: o.init() for p, o in j_opts.items()}
    t_p = convert.tree_from_numpy(jax.device_get(j_p), "cpu")
    t_st = convert.tree_from_numpy(jax.device_get(j_st), "cpu")
    assert TP.measure_aux_bytes({"v": [s["v"] for s in t_st.values()],
                                 "m": [s["m"] for s in t_st.values()]}) \
        == tplan.predicted_aux_bytes
    cmap = T_CFG.class_maps()[0]
    from repro_torch.data import pipeline as tp
    stream = tx.MetaStream(tp.ExtremeStream(T_CFG.data_config(BATCH)), cmap,
                           device="cpu")
    j_step = jax.jit(j_step)
    losses = []
    for i in range(STEPS):
        b = stream.batch(i)
        j_p, j_st, j_m = j_step(j_p, j_st,
                                {k: jnp.asarray(v.numpy())
                                 for k, v in b.items()})
        t_p, t_st, t_m = t_step(t_p, t_st, b)
        losses.append((float(j_m["loss"]), float(t_m["loss"])))
        if i == 0:      # the feature table: one step (test_torch_extreme)
            np.testing.assert_allclose(
                t_p["tok_embed"]["table"].numpy(),
                np.asarray(j_p["tok_embed"]["table"]), **TRAJ_TOL)
    want, got = np.array(losses).T
    np.testing.assert_allclose(got, want, **TRAJ_TOL)
    np.testing.assert_allclose(t_p["class_head"]["table"].numpy(),
                               np.asarray(j_p["class_head"]["table"]),
                               **TRAJ_TOL)
    j_host = jax.device_get(j_st)
    for path in j_host:
        assert int(t_st[path]["step"]) == STEPS
        assert tuple(t_st[path]["v"].shape) == j_host[path]["v"].shape
        for k in ("m", "v"):
            if j_host[path][k] is not None:
                np.testing.assert_allclose(t_st[path][k].numpy(),
                                           np.asarray(j_host[path][k]),
                                           err_msg=f"{path}/{k}", **TRAJ_TOL)


def test_planned_extreme_step_errors():
    plan = tx.plan_extreme(T_CFG, "0.5x")
    with pytest.raises(ValueError, match="baseline"):
        tx.make_extreme_step(T_CFG, optimizer="dense_adam", plan=plan,
                             device="cpu")
    with pytest.raises(ValueError, match="moment layout"):
        tx.make_extreme_step(T_CFG, optimizer="cs_adam", plan=plan,
                             device="cpu")
    # the backend argument overrides the plan's own
    _, _, opts = tx.make_extreme_step(T_CFG, plan=plan.with_backend("xla"),
                                      backend="ref", device="cpu")
    assert len(opts) == 2
