"""The port's telemetry (``repro_torch.obs`` and ``AuxStore.stats``)
against the JAX package's.

The schema, the writer's files, ``LatencyTracker`` summaries, probe-row
selection, the planner's predicted errors and the report's digest are
held exactly; a file written by either package validates under the
other and renders the same report.  Store gauges on the same state:
counts, fractions and maxima exactly, sums within rtol 1e-5.  Probe
shadows, ``rows_ema_update`` and probe errors within rtol 1e-5, atol
1e-6.  Every input is made with numpy from a seed; each package gets its
own copy of every buffer (the port writes its states in place, and
``jnp.asarray`` may alias a numpy buffer XLA still reads).  Torch runs
on one CPU thread, as in ``test_torch_dense.py``.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stores as JS
from repro.core.cleaning import CleaningSchedule as JClean
from repro.obs import metrics as JM
from repro.obs import probes as JP
from repro.obs import profiling as JPr
from repro.obs import report as JR
from repro_torch import convert
from repro_torch.core import stores as TS
from repro_torch.core.cleaning import CleaningSchedule as TClean
from repro_torch.obs import metrics as TM
from repro_torch.obs import probes as TP
from repro_torch.obs import profiling as TPr
from repro_torch.obs import report as TR

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=0.0)
# gauges that are counts, fractions of counts or maxima: no rounding
EXACT_GAUGES = ("occupancy", "max_cell", "quant_scale_max", "shard_occ_min",
                "shard_occ_max")
# 1 - |sum S| / sum |S| lies in [0, 1] and is ~0 for one-signed cells,
# where a relative bound on a difference of sums means nothing
FRACTION_OF_SUMS = ("sign_cancel",)


def _stream(n_rows, dim, steps, batch, seed=0):
    """(ids, rows) numpy batches with duplicate ids: half from the head
    (ids 0..7, so probe rows are hit), half uniform."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        head = rng.randint(0, 8, batch // 2)
        tail = rng.randint(0, n_rows, batch - batch // 2)
        ids = np.concatenate([head, tail]).astype(np.int32)
        rows = rng.randn(batch, dim).astype(np.float32)
        yield ids, rows


def _j(a):
    return jnp.asarray(np.array(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _host(tree):
    return np.asarray(jax.device_get(tree))


# ------------------------------------------------------------- schema
def test_schema_constants_match_reference():
    assert TM.SCHEMA_VERSION == JM.SCHEMA_VERSION == 1
    assert TM.REQUIRED_FIELDS == JM.REQUIRED_FIELDS
    assert TM.HISTOGRAM_FIELDS == JM.HISTOGRAM_FIELDS


@pytest.mark.parametrize("rec, msg", [
    ({"kind": "step", "step": 1, "steps_per_s": 1.0}, "schema version"),
    ({"schema": 1, "kind": "nope"}, "unknown record kind"),
    ({"schema": 1, "kind": "step", "step": 1}, "missing required field"),
    ({"schema": 1, "kind": "step", "step": -1, "steps_per_s": 1.0},
     "non-negative"),
    ({"schema": 1, "kind": "step", "step": True, "steps_per_s": 1.0},
     "non-negative"),
    ({"schema": 1, "kind": "step", "step": 1, "steps_per_s": float("nan")},
     "non-finite"),
    ({"schema": 1, "kind": "serve", "adapt_ms": {"p99_ms": float("inf")}},
     "non-finite"),
    ({"schema": 1, "kind": "meta", "run": {1: 2}}, "non-string key"),
    ({"schema": 1, "kind": "meta", "run": object()}, "non-JSON"),
])
def test_validate_rejects_as_reference(rec, msg):
    with pytest.raises(JM.SchemaError, match=msg):
        JM.validate_record(rec)
    with pytest.raises(TM.SchemaError, match=msg):
        TM.validate_record(rec)


def _write_run(M, path):
    with M.MetricsWriter(path, run_meta={"workload": "x", "n": 3},
                         flush_every=2) as w:
        w.write("step", step=10, steps_per_s=12.5, loss=0.5)
        w.write("table", step=10, table="emb", v_occupancy=0.25,
                v_meas_error=0.7, v_pred_error=0.1, v_error_ratio=7.0)
        w.write("phase", step=10, phases={"step": {"count": 2,
                                                   "total_ms": 3.0,
                                                   "mean_ms": 1.5}})
        w.write("serve", adapt_ms={"count": 3, "mean_ms": 1.0,
                                   "p50_ms": 1.0, "p90_ms": 2.0,
                                   "p99_ms": 80.0, "max_ms": 90.0},
                slo_p99_ms=50.0, shed_rate=0.1, n_shed=2, n_requests=20)
        assert w.records_written == 5
    return path / "metrics.jsonl"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_validate_under_both_packages(tmp_path, writer):
    path = _write_run(JM if writer == "jax" else TM, tmp_path)
    recs_j, recs_t = JM.validate_file(path), TM.validate_file(path)
    assert recs_j == recs_t
    assert [r["kind"] for r in recs_t] == ["meta", "step", "table", "phase",
                                           "serve"]
    assert TM.latest(recs_t, "table", table="emb") \
        == JM.latest(recs_j, "table", table="emb")


def test_writers_write_the_same_bytes(tmp_path):
    a = _write_run(JM, tmp_path / "j").read_bytes()
    b = _write_run(TM, tmp_path / "t").read_bytes()
    assert a == b


def test_write_rejects_bad_record_before_buffering(tmp_path):
    w = TM.MetricsWriter(tmp_path)
    with pytest.raises(TM.SchemaError):
        w.write("step", step=1, steps_per_s=float("nan"))
    w.close()
    assert len(JM.validate_file(w.path)) == 1      # just the meta record


def test_validate_file_flags_corrupt_line(tmp_path):
    p = tmp_path / "metrics.jsonl"
    p.write_text(json.dumps({"schema": 1, "kind": "meta", "run": {}})
                 + "\nnot json\n")
    with pytest.raises(TM.SchemaError, match=":2"):
        TM.validate_file(p)


def test_default_metrics_path_and_run_id(tmp_path):
    assert TM.default_metrics_path(tmp_path) \
        == JM.default_metrics_path(tmp_path)
    f = tmp_path / "x.jsonl"
    assert TM.default_metrics_path(f) == JM.default_metrics_path(f)
    assert TM.run_id_from_env() == JM.run_id_from_env()


def test_step_accumulator_matches_reference():
    rng = np.random.RandomState(0)
    vals = rng.randn(7, 3).astype(np.float32)
    ja, ta = JM.StepAccumulator(), TM.StepAccumulator()
    for row in vals:
        ja.add({"loss": _j(row[0]), "dedup": _j(row[1]),
                "host": float(row[2])})
        ta.add({"loss": _t(row[0]), "dedup": _t(row[1]),
                "host": float(row[2])})
    assert ta.count == ja.count == 7
    want, got = ja.drain(), ta.drain()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **SUM_TOL)
    assert ta.count == 0 and ta.drain() == {}


# ------------------------------------------------------------- profiling
@pytest.mark.parametrize("capacity,n", [(128, 100), (64, 300), (4096, 1)])
def test_latency_tracker_summaries_equal_reference(capacity, n):
    rng = np.random.RandomState(capacity + n)
    jl, tl = JPr.LatencyTracker(capacity), TPr.LatencyTracker(capacity)
    for s in rng.exponential(2e-3, n):
        jl.record(s)
        tl.record(s)
    assert tl.summary() == jl.summary()
    assert tl.per_second() == jl.per_second()
    assert tl.count == jl.count == n
    assert TPr.LatencyTracker(4).summary() == JPr.LatencyTracker(4).summary()


def test_phase_timer_drains_counts():
    pt = TPr.PhaseTimer()
    for _ in range(3):
        with pt.phase("step"):
            pass
    with pt.phase("data"):
        pass
    out = pt.drain()
    assert {k: v["count"] for k, v in out.items()} == {"step": 3, "data": 1}
    assert set(out["step"]) == {"count", "total_ms", "mean_ms"}
    assert pt.drain() == {}


def test_maybe_trace_writes_spans(tmp_path):
    with TPr.maybe_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with TPr.maybe_trace(str(tmp_path)):
        with TPr._trace_annotation("obs.adapt"):
            torch.ones(4).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "obs.adapt" in names


def test_scope_is_free_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a):
        entered.append(name)
        return real(name, *a)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    ctx = TPr.scope("obs.dedup")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx:
        torch.ones(4).sum()
    assert entered == []
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with TPr.scope("obs.dedup"):
            torch.ones(4).sum()
    assert entered == ["obs.dedup"]
    assert "obs.dedup" in {e.name for e in prof.events()}
    # the state is read at every call: a profiler started after a
    # span's first use sees its next one
    with torch.profiler.profile(activities=acts) as prof:
        with TPr.scope("obs.hash"):
            pass
    assert "obs.hash" in {e.name for e in prof.events()}


def test_scope_is_seen_by_a_dispatch_mode():
    from repro_torch.launch.op_cost import OpCost
    with OpCost(sources=True) as cost:
        with TPr.scope("obs.clip"):
            torch.ones(4, device="meta").sum()
    assert any(src.startswith("obs.clip") for _op, src in cost.rows)


# ------------------------------------------------------------- store gauges
def _sketch_pair(kind, dtype, shape, *, shards=1, cleaning=None):
    jcls = {"sketch": JS.CountSketchStore, "countmin": JS.CountMinStore}[kind]
    tcls = {"sketch": TS.CountSketchStore, "countmin": TS.CountMinStore}[kind]
    kw = dict(depth=3, width=1024, dtype=dtype, shards=shards)
    jkw, tkw = dict(kw), dict(kw)
    if cleaning is not None:
        jkw["cleaning"] = JClean(*cleaning)
        tkw["cleaning"] = TClean(*cleaning)
    return (jcls(**jkw).bind("t", shape, jnp.float32),
            tcls(**tkw).bind("t", shape))


def _driven_state(js, ts, n, d, seed):
    """A sketch state from the reference's own updates (a third of the
    cells stay zero), and the port's copy of it."""
    from repro.core import sketch as jcs
    rng = np.random.RandomState(seed)
    state = js.init()
    ids = rng.randint(0, n, 300).astype(np.int32)
    delta = rng.randn(300, d).astype(np.float32)
    if not js.spec.signed:
        delta = np.abs(delta)
    state = jcs.update(js.spec, state, _j(ids), _j(delta))
    return state, convert.tree_from_numpy(jax.device_get(state), "cpu")


def _assert_gauges(want, got):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        w, g = float(np.asarray(w)), float(got[k])
        if k in EXACT_GAUGES:
            assert g == w, (k, g, w)
        elif k in FRACTION_OF_SUMS:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **SUM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["sketch", "countmin"])
def test_sketch_stats_match_reference(kind, dtype):
    """3 x 1,024 x 8 = 24,576 cells: the strided sample (stride 3)."""
    n, d = 2000, 8
    js, ts = _sketch_pair(kind, dtype, (n, d))
    jstate, tstate = _driven_state(js, ts, n, d, seed=len(dtype))
    assert int(np.prod(js.spec.shape)) > 2 * TS.STATS_SAMPLE_CELLS
    _assert_gauges(js.stats(jstate), ts.stats(tstate))


def test_sharded_sketch_stats_match_reference():
    n, d = 2000, 8
    js, ts = _sketch_pair("sketch", "float32", (n, d), shards=4)
    jstate, tstate = _driven_state(js, ts, n, d, seed=5)
    got = ts.stats(tstate)
    assert "shard_occ_min" in got
    _assert_gauges(js.stats(jstate), got)


@pytest.mark.parametrize("pending", [False, True])
def test_cleaned_countmin_stats_and_schedule(pending):
    n, d = 2000, 8
    js, ts = _sketch_pair("countmin", "float32", (n, d), cleaning=(0.3, 7))
    jstate, tstate = _driven_state(js, ts, n, d, seed=6)
    _assert_gauges(js.stats(jstate, clean_pending=pending),
                   ts.stats(tstate, clean_pending=pending))
    for a, b in ((0, 20), (7, 14), (6, 7), (20, 10), (-3, 50)):
        assert ts.cleans_between(a, b) == js.cleans_between(a, b)
    assert TS.CountMinStore().bind("t", (n, d)).cleans_between(0, 100) == 0


@pytest.mark.parametrize("shape", [(40, 6), (3000, 8)])
def test_dense_stats_match_reference(shape):
    rng = np.random.RandomState(shape[0])
    x = rng.randn(*shape).astype(np.float32)
    x[rng.rand(*shape) < 0.4] = 0.0
    js = JS.DenseStore().bind("t", shape, jnp.float32)
    ts = TS.DenseStore().bind("t", shape)
    _assert_gauges(js.stats(_j(x)), ts.stats(_t(x)))


def test_rank1_stats_match_reference():
    rng = np.random.RandomState(3)
    r = np.abs(rng.randn(300)).astype(np.float32)
    r[::4] = 0.0
    c = np.abs(rng.randn(12)).astype(np.float32)
    js = JS.Rank1Store().bind("t", (300, 12), jnp.float32)
    ts = TS.Rank1Store().bind("t", (300, 12))
    _assert_gauges(js.stats(JS.Rank1Moment(_j(r), _j(c))),
                   ts.stats(TS.Rank1Moment(_t(r), _t(c))))


def test_base_store_stats_empty():
    assert TS.AuxStore().stats(None) == {}


# ------------------------------------------------------------- probes
@pytest.mark.parametrize("n,k", [(10_000, 16), (4, 16), (1000, 8), (17, 5),
                                 (151_936, 16)])
def test_probe_row_ids_match_reference(n, k):
    assert TP.probe_row_ids(n, k) == JP.probe_row_ids(n, k)


def _store_pair(kind):
    n, d = 1000, 4
    if kind == "dense":
        return (JS.DenseStore().bind("t", (n, d), jnp.float32),
                TS.DenseStore().bind("t", (n, d)))
    if kind == "countmin":
        return (JS.CountMinStore(depth=1, width=8).bind("t", (n, d),
                                                        jnp.float32),
                TS.CountMinStore(depth=1, width=8).bind("t", (n, d)))
    if kind == "countmin3":
        return (JS.CountMinStore(depth=3, width=64).bind("t", (n, d),
                                                         jnp.float32),
                TS.CountMinStore(depth=3, width=64).bind("t", (n, d)))
    return (JS.CountMinStore(compression=4.0, dtype="int8").bind(
                "t", (n, d), jnp.float32),
            TS.CountMinStore(compression=4.0, dtype="int8").bind("t", (n, d)))


def _drive_probes(kind, steps=25):
    """The same stream through each package's ``rows_ema_update`` and
    probe shadow; returns (jax (state, pstate, probe, store), port's)."""
    n, d, batch = 1000, 4, 32
    js, ts = _store_pair(kind)
    jprobe = JP.TableProbe.for_table("t", n, k=8, track_first_moment=False)
    tprobe = TP.TableProbe.for_table("t", n, k=8, track_first_moment=False)
    jst, tst = js.init(), ts.init("cpu")
    jps, tps = jprobe.init(d), tprobe.init(d, "cpu")
    for ids, rows in _stream(n, d, steps, batch):
        jst = JP.rows_ema_update(js, jst, _j(ids), _j(rows), jprobe.b2,
                                 square=True)
        jps = jprobe.update(jps, _j(ids), _j(rows))
        tst = TP.rows_ema_update(ts, tst, _t(ids), _t(rows), tprobe.b2,
                                 square=True)
        tps = tprobe.update(tps, _t(ids), _t(rows))
    return (jst, jps, jprobe, js), (tst, tps, tprobe, ts)


@pytest.mark.parametrize("kind", ["dense", "countmin", "countmin3", "int8"])
def test_probe_shadow_and_errors_match_reference(kind):
    (jst, jps, jprobe, js), (tst, tps, tprobe, ts) = _drive_probes(kind)
    assert tprobe.probe_ids == jprobe.probe_ids
    assert tps["pm"] is None and jps["pm"] is None
    np.testing.assert_array_equal(tps["hits"].numpy(), _host(jps["hits"]))
    np.testing.assert_allclose(tps["pv"].numpy(), _host(jps["pv"]), **TOL)
    for a, b in zip(convert.tree_to_numpy(tst if isinstance(tst, tuple)
                                          else (tst,)),
                    jax.tree_util.tree_leaves(jax.device_get(jst))):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **TOL)
    want = jprobe.errors(jps, v_store=js, v_state=jst)
    got = tprobe.errors(tps, v_store=ts, v_state=tst)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_probe_pin_dense_zero_overcompressed_positive():
    """The reference's acceptance pin, on the port: a DenseStore measures
    zero error, an over-compressed count-min a positive one, cold rows
    included."""
    dense = _drive_probes("dense")[1]
    errs = dense[2].errors(dense[1], v_store=dense[3], v_state=dense[0])
    assert errs["probe_rows_seen"] >= 4
    np.testing.assert_allclose(errs["v_meas_error"], 0.0, atol=1e-5)
    cms = _drive_probes("countmin")[1]
    errs = cms[2].errors(cms[1], v_store=cms[3], v_state=cms[0])
    assert errs["v_meas_error"] > 0.1 and errs["v_meas_error_cold"] > 0.0


def test_quant_noise_gauge_int8_only():
    t = _drive_probes("int8")[1]
    errs = t[2].errors(t[1], v_store=t[3], v_state=t[0])
    assert 0.0 < errs["v_quant_noise"] < 100 * max(errs["v_meas_error"],
                                                   1e-6)
    t = _drive_probes("countmin3")[1]
    assert "v_quant_noise" not in t[2].errors(t[1], v_store=t[3],
                                              v_state=t[0])


def test_probe_tracks_first_moment_like_reference():
    n, d = 300, 6
    jprobe = JP.TableProbe.for_table("t", n, k=6)
    tprobe = TP.TableProbe.for_table("t", n, k=6)
    jps, tps = jprobe.init(d), tprobe.init(d, "cpu")
    for ids, rows in _stream(n, d, 6, 40, seed=4):
        jps = jprobe.update(jps, _j(ids), _j(rows))
        tps = tprobe.update(tps, _t(ids), _t(rows))
    for k in ("pm", "pv"):
        np.testing.assert_allclose(tps[k].numpy(), _host(jps[k]), **TOL)


@pytest.mark.parametrize("alpha", [1.05, 1.1, 1.4])
def test_predicted_errors_match_reference(alpha):
    jv = JS.CountMinStore(depth=2, width=64).bind("t", (1000, 4), jnp.float32)
    tv = TS.CountMinStore(depth=2, width=64).bind("t", (1000, 4))
    jm = JS.CountSketchStore(depth=3, width=32).bind("t", (1000, 4),
                                                     jnp.float32)
    tm = TS.CountSketchStore(depth=3, width=32).bind("t", (1000, 4))
    assert TP.predicted_table_errors(tm, tv, 1000, alpha=alpha) \
        == JP.predicted_table_errors(jm, jv, 1000, alpha=alpha)
    assert TP.predicted_table_errors(None, tv, 1000) \
        == JP.predicted_table_errors(None, jv, 1000)
    d = TS.DenseStore().bind("t", (100, 4))
    assert TP.predicted_table_errors(d, d, 100) == {"m_pred_error": 0.0,
                                                    "v_pred_error": 0.0}


# ------------------------------------------------------------- observer
N_OBS, D_OBS = 512, 4


def _observe(pkg, path, steps=20, log_every=10):
    """The reference's observer end-to-end run (tests/test_obs.py) in one
    package, on the numpy stream: m a width-8 count sketch, v a width-8
    count-min cleaned every 7 steps, an 8-row probe."""
    S, P, M, Pr = (JS, JP, JM, JPr) if pkg == "jax" else (TS, TP, TM, TPr)
    Clean = JClean if pkg == "jax" else TClean
    bind = (lambda s: s.bind("t", (N_OBS, D_OBS), jnp.float32)) \
        if pkg == "jax" else (lambda s: s.bind("t", (N_OBS, D_OBS)))
    arr = _j if pkg == "jax" else _t
    m_store = bind(S.CountSketchStore(depth=1, width=8))
    v_store = bind(S.CountMinStore(depth=1, width=8,
                                   cleaning=Clean(0.5, 7)))
    probe = P.TableProbe.for_table("t", N_OBS, k=8)
    mon = P.TableMonitor(
        path="t", m_store=m_store, v_store=v_store, probe=probe,
        predicted=P.predicted_table_errors(m_store, v_store, N_OBS))
    obs = P.RunObserver(M.MetricsWriter(path, run_meta={"n": N_OBS}),
                        monitors=[mon], log_every=log_every,
                        phase_timer=Pr.PhaseTimer())
    if pkg == "jax":
        st = {"m": m_store.init(), "v": v_store.init(),
              "probe": probe.init(D_OBS)}
    else:
        st = {"m": m_store.init("cpu"), "v": v_store.init("cpu"),
              "probe": probe.init(D_OBS, "cpu")}
    for i, (ids, rows) in enumerate(_stream(N_OBS, D_OBS, steps, 32),
                                    start=1):
        with obs.phase("step"):
            st["m"] = P.rows_ema_update(m_store, st["m"], arr(ids),
                                        arr(rows), probe.b1)
            st["v"] = P.rows_ema_update(v_store, st["v"], arr(ids),
                                        arr(rows), probe.b2, square=True)
            st["probe"] = probe.update(st["probe"], arr(ids), arr(rows))
        obs.on_step(i, {"step": i, "time_s": 1e-3, "loss": 1.0}, st)
    obs.close(steps, st)
    return M.validate_file(path / "metrics.jsonl")


def _tables(recs):
    return [r for r in recs if r["kind"] == "table"]


def test_observer_end_to_end(tmp_path):
    recs = _observe("torch", tmp_path)
    kinds = [r["kind"] for r in recs]
    assert kinds.count("step") == 2 and kinds.count("phase") == 2
    tables = _tables(recs)
    assert [t["step"] for t in tables] == [10, 20]
    last = tables[-1]
    for field in ("v_occupancy", "v_mass", "v_meas_error", "v_pred_error",
                  "v_error_ratio", "m_sign_cancel", "probe_rows_seen",
                  "cleans_in_window", "v_clean_next_removes"):
        assert field in last, field
    assert last["cleans_in_window"] == 1        # step 14 in (10, 20]
    assert last["v_meas_error"] > 0.0           # over-compressed


def test_observer_records_match_reference(tmp_path):
    want = _observe("jax", tmp_path / "j")
    got = _observe("torch", tmp_path / "t")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for w, g in zip(_tables(want), _tables(got)):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)
            else:
                assert g[k] == v, k
    steps_w = [r for r in want if r["kind"] == "step"]
    steps_g = [r for r in got if r["kind"] == "step"]
    assert steps_g == steps_w


def test_report_digest_same_on_both_packages_files(tmp_path):
    recs_j = _observe("jax", tmp_path / "j")
    recs_t = _observe("torch", tmp_path / "t")
    for recs in (recs_j, recs_t):
        want, got = JR.analyze(recs), TR.analyze(recs)
        assert [w.split(":")[0] for w in got["warnings"]] \
            == [w.split(":")[0] for w in want["warnings"]]
        assert got["warnings"] == want["warnings"]
        assert got["tables"] == want["tables"]
        assert got["meta"] == want["meta"] == {"schema": 1, "kind": "meta",
                                               "run": {"n": N_OBS}}
    cats = {w.split(":")[0] for w in TR.analyze(recs_t)["warnings"]}
    assert "probe-error" in cats


def test_report_healthy_on_dense(tmp_path):
    w = TM.MetricsWriter(tmp_path, run_meta={})
    w.write("step", step=10, steps_per_s=10.0)
    w.write("table", step=10, table="t", v_occupancy=0.99,
            v_pred_error=0.0, v_meas_error=0.0)
    w.close()
    assert TR.analyze(TM.validate_file(w.path))["warnings"] == []


def _hist(p99):
    return {"count": 10, "mean_ms": p99 / 2, "p50_ms": p99 / 2,
            "p90_ms": p99 * 0.9, "p99_ms": p99, "max_ms": p99}


def _serve(**kw):
    return {"schema": 1, "kind": "serve", **kw}


@pytest.mark.parametrize("recs, kw", [
    ([_serve(adapt_ms=_hist(80.0), slo_p99_ms=50.0, shed_rate=0.0)], {}),
    ([_serve(adapt_ms=_hist(80.0))], {}),
    ([_serve(adapt_ms=_hist(80.0))], {"serve_p99_warn": 50.0}),
    ([_serve(adapt_ms=_hist(1.0), slo_p99_ms=50.0, shed_rate=0.25,
             n_shed=5, n_requests=20)], {}),
    ([_serve(adapt_ms=_hist(10.0), slo_p99_ms=50.0, shed_rate=0.0)], {}),
    ([{"schema": 1, "kind": "table", "step": 3, "table": "e",
       "v_occupancy": 0.9, "m_occupancy": 0.95, "m_pred_error": 0.0,
       "v_shard_occ_min": 0.1, "v_shard_occ_max": 0.5,
       "v_error_ratio": 4.0, "v_meas_error": 0.8, "v_pred_error": 0.2}],
     {}),
    ([{"schema": 1, "kind": "table", "step": 3, "table": "e",
       "v_shard_occ_min": 0.1, "v_shard_occ_max": 0.15}],
     {"shard_imbalance_warn": 1.2, "occupancy_warn": 0.5}),
])
def test_report_warnings_match_reference(recs, kw):
    want, got = JR.analyze(recs, **kw), TR.analyze(recs, **kw)
    assert got["warnings"] == want["warnings"]
    jbuf, tbuf = io.StringIO(), io.StringIO()
    JR.render(want, out=jbuf)
    TR.render(got, out=tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()


def test_report_strict_exit_and_render(tmp_path):
    with TM.MetricsWriter(tmp_path, run_meta={}) as w:
        w.write("serve", adapt_ms=_hist(80.0), slo_p99_ms=50.0,
                shed_rate=0.1, n_shed=2, n_requests=20, n_batches=4,
                request_ms=_hist(90.0), reads_per_s=100.0)
    path = str(tmp_path / "metrics.jsonl")
    assert TR.main([path]) == JR.main([path]) == 0
    assert TR.main([path, "--strict"]) == JR.main([path, "--strict"]) == 1
    assert TR.main([str(tmp_path), "--strict", "--serve-p99-warn", "10"]) == 1
    buf = io.StringIO()
    TR.render(TR.analyze(TM.validate_file(path)), out=buf)
    out = buf.getvalue()
    assert "serve-slo" in out and "serve-shed" in out
    assert "p50" in out and "p99" in out
    assert "request latency" in out and "shed: 2/20" in out


def test_timed_adapt_emits_schema_valid_serve_record(tmp_path):
    from repro_torch.serve.steps import timed_adapt
    adapt, lat = timed_adapt(lambda table, st, ids, rows: (table + 1.0, st))
    table, st = torch.zeros((4, 2)), {}
    for _ in range(5):
        table, st = adapt(table, st, torch.zeros((2,), dtype=torch.int32),
                          torch.zeros((2, 2)))
    assert lat.count == 5 and float(table[0, 0]) == 5.0
    with TM.MetricsWriter(tmp_path, run_meta={}) as w:
        w.write("serve", adapt_ms=lat.summary(),
                reads_per_s=lat.per_second())
    recs = JM.validate_file(tmp_path / "metrics.jsonl")
    assert recs[-1]["adapt_ms"]["count"] == 5
