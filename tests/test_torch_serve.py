"""The port's online-adaptation serving (``repro_torch.serve``) against the
JAX package's, and the reference's own serving contract on the port.

Held to the reference: traces bit for bit (ids, rows, arrivals, users),
``coalesce`` bit for bit, ``dedup_coalesce``'s integers bit for bit and
its sums within rtol 1e-5, atol 1e-6, the dense adapt step within the
same tolerance, and an ``AdaptServer`` replay of one trace in each
package: with both servers' clocks replaced by the same fake clock,
batching and shedding are deterministic, so the batch count, the shed
count, each completion's state and version, and the serve record's
counts must be equal, and the final table and V within rtol 1e-4, atol
1e-5.

The reference's contract (``tests/test_serve.py``) on the port: the
batcher's triggers and guards, a coalesced batch bit-equal to the raw
concatenation, the forced interleaving and threaded readers of the
double buffer, writer misuse, backpressure, the serve record, and the
dp-only arguments rejected.  The port's adapt steps write their inputs
in place, so every reference trajectory here runs on copies, and every
buffer each package gets is its own.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.server as jserver_mod
import repro_torch.serve.server as tserver_mod
from repro import serve as J
from repro.obs.metrics import validate_file as j_validate_file
from repro_torch import serve as T
from repro_torch.core.cleaning import CleaningSchedule
from repro_torch.core.optimizers import SketchHParams
from repro_torch.core.stores import CountMinStore
from repro_torch.obs.metrics import MetricsWriter, validate_file
from repro_torch.serve.buffer import clone_tree

torch.set_num_threads(1)

N_ROWS, DIM = 256, 8
TOL = dict(rtol=1e-5, atol=1e-6)
REPLAY_TOL = dict(rtol=1e-4, atol=1e-5)


def _req(pkg, ids, *, user=0, t=0.0, seed=0, scale=0.1):
    ids = np.asarray(ids, np.int32)
    rng = np.random.RandomState(seed)
    rows = (rng.standard_normal((ids.shape[0], DIM)) * scale
            ).astype(np.float32)
    return pkg.AdaptRequest(user=user, ids=ids, grad_rows=rows, t_arrival=t)


def _make_step(**kw):
    return T.make_online_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9,
                                    device="cpu", **kw)


def _table(seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        N_ROWS, DIM).astype(np.float32))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------- traffic
@pytest.mark.parametrize("cfg", [
    dict(n_requests=50, n_rows=128, dim=4, seed=7),
    dict(n_requests=400, n_rows=512, dim=4, alpha=1.4, seed=1),
    dict(n_requests=10, arrival="uniform", offered_load=100.0, seed=0),
    dict(n_requests=30, n_users=3, n_rows=151_936, dim=16,
         ids_per_request=8, alpha=1.1, offered_load=5000.0, seed=0),
])
def test_trace_bit_equal_to_reference(cfg):
    want = J.make_trace(J.TraceConfig(**cfg))
    got = T.make_trace(T.TraceConfig(**cfg))
    assert len(got) == len(want) == cfg["n_requests"]
    for a, b in zip(got, want):
        assert a.user == b.user and a.t_arrival == b.t_arrival
        assert a.ids.dtype == b.ids.dtype and a.grad_rows.dtype \
            == b.grad_rows.dtype
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.grad_rows, b.grad_rows)
    assert T.trace_stats(got) == J.trace_stats(want)


def test_trace_properties():
    cfg = T.TraceConfig(n_requests=400, n_rows=512, dim=4, alpha=1.4, seed=1)
    trace = T.make_trace(cfg)
    ts = [r.t_arrival for r in trace]
    assert ts == sorted(ts)
    all_ids = np.concatenate([r.ids for r in trace])
    counts = np.bincount(all_ids, minlength=cfg.n_rows)
    assert counts.max() > 5 * counts.mean()
    assert T.trace_stats(trace)["dup_ratio"] > 1.0
    gaps = np.diff([r.t_arrival for r in T.make_trace(T.TraceConfig(
        n_requests=10, arrival="uniform", offered_load=100.0))])
    np.testing.assert_allclose(gaps, 0.01, rtol=1e-6)
    with pytest.raises(ValueError, match="arrival"):
        T.make_trace(T.TraceConfig(arrival="bursty"))


# ------------------------------------------------------------- batcher
def test_size_trigger_before_deadline():
    b = T.Batcher(T.BatcherConfig(batch_ids=8, max_delay_s=10.0), "cpu")
    b.add(_req(T, [1, 2, 3, 4], t=0.0))
    assert not b.ready(now=0.0)
    b.add(_req(T, [5, 6, 7, 8], t=0.001))
    assert b.ready(now=0.001)
    batch = b.poll(now=0.001)
    assert batch is not None and len(batch) == 2 and batch.n_live == 8
    assert batch.copied is None and len(b) == 0


def test_deadline_trigger():
    b = T.Batcher(T.BatcherConfig(batch_ids=64, max_delay_s=0.005), "cpu")
    assert b.deadline() is None and b.flush() is None
    b.add(_req(T, [1, 2], t=1.0))
    assert b.deadline() == pytest.approx(1.005)
    assert not b.ready(now=1.004) and b.ready(now=1.005)
    batch = b.flush()
    assert batch.t_oldest == 1.0 and batch.n_live == 2


def test_capacity_guards():
    b = T.Batcher(T.BatcherConfig(batch_ids=4), "cpu")
    with pytest.raises(ValueError, match="never fit"):
        b.add(_req(T, [1, 2, 3, 4, 5]))
    b.add(_req(T, [1, 2, 3]))
    assert not b.fits(_req(T, [4, 5]))
    with pytest.raises(ValueError, match="does not fit"):
        b.add(_req(T, [4, 5]))
    with pytest.raises(ValueError, match="batch_ids"):
        T.Batcher(T.BatcherConfig(batch_ids=0), "cpu")
    with pytest.raises(ValueError, match="empty"):
        T.coalesce([], 8, "cpu")
    with pytest.raises(ValueError, match="id slots"):
        T.coalesce([_req(T, [1, 2, 3])], 2, "cpu")


def _requests(pkg, n, k, seed=10):
    return [_req(pkg, np.random.RandomState(seed + i).randint(0, N_ROWS, k),
                 seed=seed + 10 + i, t=i * 1e-4) for i in range(n)]


@pytest.mark.parametrize("n,k,batch_ids", [(2, 2, 8), (5, 8, 64),
                                           (4, 8, 32), (1, 1, 1)])
def test_coalesce_bit_equal_to_reference(n, k, batch_ids):
    jids, jrows = J.coalesce(_requests(J, n, k), batch_ids)
    tids, trows = T.coalesce(_requests(T, n, k), batch_ids, "cpu")
    assert tids.dtype == torch.int32 and trows.dtype == torch.float32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    live = n * k
    assert (tids[live:] == tids[0]).all() and not trows[live:].any()


@pytest.mark.parametrize("n,k,batch_ids", [(2, 3, 8), (5, 8, 64),
                                           (6, 8, 48), (3, 8, 24)])
def test_dedup_coalesce_matches_reference(n, k, batch_ids):
    jids, jrows = J.coalesce(_requests(J, n, k, seed=3), batch_ids)
    tids, trows = T.coalesce(_requests(T, n, k, seed=3), batch_ids, "cpu")
    ju, js, jn = J.dedup_coalesce(jids, jrows)
    tu, ts, tn = T.dedup_coalesce(tids, trows)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # fill slots: the first live id, zero rows (never the raw -1)
    m = int(tn)
    assert (tu[m:] == tu[0]).all() and not ts[m:].any() and (tu >= 0).all()
    ref = {}
    for i, rid in enumerate(tids.tolist()):
        ref[rid] = ref.get(rid, 0.0) + trows[i].numpy()
    np.testing.assert_array_equal(tu[:m].numpy(), sorted(ref))


# ------------------------------------------------------------- adapt steps
def test_dense_adapt_step_matches_reference():
    jinit, jadapt = J.make_dense_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9)
    tinit, tadapt = T.make_dense_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9,
                                            device="cpu")
    table0 = _table(0).numpy()
    jt, js = jnp.asarray(table0.copy()), jinit()
    tt, ts = torch.from_numpy(table0.copy()), tinit()
    for i in range(4):
        ids, rows = T.coalesce(_requests(T, 4, 8, seed=20 * i), 40, "cpu")
        jt, js = jadapt(jt, js, jnp.asarray(ids.numpy()),
                        jnp.asarray(rows.numpy()))
        tt, ts = tadapt(tt, ts, ids, rows)
    assert int(ts["step"]) == int(js["step"]) == 4
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    for k in ("m", "v"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)


@pytest.mark.parametrize("arm", ["countmin", "countmin-tiled", "dense"])
def test_coalesced_step_bit_identical_to_raw_concat(arm):
    if arm == "dense":
        init_fn, adapt_fn = T.make_dense_adapt_step(N_ROWS, DIM, lr=1e-2,
                                                    b2=0.9, device="cpu")
    else:
        init_fn, adapt_fn = _make_step(
            store_backend="tiled" if arm.endswith("tiled") else None)
    table = _table(0)
    reqs = _requests(T, 5, 8)
    raw_ids = torch.from_numpy(np.concatenate([r.ids for r in reqs]))
    raw_rows = torch.from_numpy(np.concatenate([r.grad_rows for r in reqs]))
    t_ref, s_ref = adapt_fn(table.clone(), init_fn(), raw_ids, raw_rows)
    ids, rows = T.coalesce(reqs, 64, "cpu")        # 40 live + 24 pad slots
    t_b, s_b = adapt_fn(table.clone(), init_fn(), ids, rows)
    assert torch.equal(t_ref, t_b)
    assert _leaves_equal(s_ref, s_b)


def test_server_replay_bit_identical_one_batch():
    init_fn, adapt_fn = _make_step()
    table = _table(1)
    reqs = _requests(T, 5, 8)
    raw_ids = torch.from_numpy(np.concatenate([r.ids for r in reqs]))
    raw_rows = torch.from_numpy(np.concatenate([r.grad_rows for r in reqs]))
    t_ref, s_ref = adapt_fn(table.clone(), init_fn(), raw_ids, raw_rows)
    srv = T.AdaptServer(table, init_fn(), adapt_fn,
                        T.ServerConfig(batch_ids=64, max_delay_s=1.0,
                                       queue_cap=64))
    comps = T.replay(srv, reqs, warmup=False)
    assert srv.n_batches == 1 and all(c.result() == 1 for c in comps)
    snap = srv.store.read()
    assert torch.equal(t_ref, snap.table)
    assert _leaves_equal(s_ref, snap.opt_state)


def test_multi_batch_matches_sequential_steps():
    init_fn, adapt_fn = _make_step()
    table = _table(2)
    reqs = _requests(T, 6, 8)
    srv = T.AdaptServer(table.clone(), init_fn(), adapt_fn,
                        T.ServerConfig(batch_ids=16, max_delay_s=1.0,
                                       queue_cap=64))
    T.replay(srv, reqs, warmup=False)
    assert srv.n_batches == 3
    t_ref, s_ref = table.clone(), init_fn()
    for i in range(0, 6, 2):
        ids, rows = T.coalesce(reqs[i:i + 2], 16, "cpu")
        t_ref, s_ref = adapt_fn(t_ref, s_ref, ids, rows)
    snap = srv.store.read()
    assert torch.equal(t_ref, snap.table)
    assert _leaves_equal(s_ref, snap.opt_state)


def test_warmup_leaves_published_generation_untouched():
    init_fn, adapt_fn = _make_step()
    table = _table(3)
    srv = T.AdaptServer(table.clone(), init_fn(), adapt_fn, T.ServerConfig(
        batch_ids=16))
    # a state that has moved, so a zero-gradient step would change it
    srv.store.begin_adapt()
    t, s = adapt_fn(table.clone(), init_fn(), *T.coalesce(
        _requests(T, 2, 8), 16, "cpu"))
    srv.store.stage(t, s)
    before = clone_tree(srv.store.publish())
    srv.warmup()
    after = srv.store.read()
    assert after.version == before.version == 1
    assert torch.equal(after.table, before.table)
    assert _leaves_equal(after.opt_state, before.opt_state)


# ------------------------------------------------------------- double buffer
def test_forced_interleaving_never_torn():
    init_fn, adapt_fn = _make_step()
    table0 = _table(3)
    ids = torch.arange(16, dtype=torch.int32) % N_ROWS
    rows = torch.from_numpy(np.random.RandomState(4).randn(16, DIM).astype(
        np.float32) * 0.1)
    # offline reference trajectory on copies: generation i = i steps
    refs = [(table0.clone(), init_fn())]
    for _ in range(3):
        refs.append(adapt_fn(*clone_tree(refs[-1]), ids, rows))

    store = T.DoubleBufferedStore(table0, init_fn())
    for gen in range(3):
        t_in, s_in = store.begin_adapt()
        out = adapt_fn(t_in, s_in, ids, rows)
        # adapt computed but NOT staged: readers still see gen
        snap = store.read()
        assert snap.version == gen
        assert torch.equal(snap.table, refs[gen][0])
        assert _leaves_equal(snap.opt_state, refs[gen][1])
        store.stage(*out)
        # staged but NOT published: still the old complete generation
        snap = store.read()
        assert snap.version == gen
        assert torch.equal(snap.table, refs[gen][0])
        assert _leaves_equal(snap.opt_state, refs[gen][1])
        store.publish()
        # published: the new complete generation, atomically
        snap = store.read()
        assert snap.version == gen + 1
        assert torch.equal(snap.table, refs[gen + 1][0])
        assert _leaves_equal(snap.opt_state, refs[gen + 1][1])


def test_held_generation_keeps_its_bits():
    """A reader holding generation N reads the same bits after two more
    publishes: the writer only ever changes its own copy."""
    init_fn, adapt_fn = _make_step()
    store = T.DoubleBufferedStore(_table(5), init_fn())
    ids = torch.arange(8, dtype=torch.int32)
    rows = torch.ones((8, DIM)) * 0.1
    for _ in range(2):
        store.stage(*adapt_fn(*store.begin_adapt(), ids, rows))
        store.publish()
    held = store.read()
    frozen = clone_tree((held.table, held.opt_state))
    for _ in range(2):
        store.stage(*adapt_fn(*store.begin_adapt(), ids, rows))
        store.publish()
    assert store.version == held.version + 2
    assert torch.equal(held.table, frozen[0])
    assert _leaves_equal(held.opt_state, frozen[1])
    assert not torch.equal(store.read().table, held.table)


def test_threaded_readers_see_consistent_pairs():
    store = T.DoubleBufferedStore(torch.zeros((4, 4)),
                                  {"step": torch.zeros((), dtype=torch.int32)})
    stop = threading.Event()
    violations = []

    def reader():
        while not stop.is_set():
            snap = store.read()
            t = float(snap.table[0, 0])
            s = int(snap.opt_state["step"])
            if not (t == s == snap.version):
                violations.append((t, s, snap.version))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for gen in range(1, 60):
            store.begin_adapt()
            store.stage(torch.full((4, 4), float(gen)),
                        {"step": torch.tensor(gen, dtype=torch.int32)})
            store.publish()
    finally:
        stop.set()
        for th in threads:
            th.join()
    assert violations == []


def test_writer_misuse_guards():
    store = T.DoubleBufferedStore(torch.zeros((2,)), {})
    with pytest.raises(RuntimeError, match="nothing staged"):
        store.publish()
    store.begin_adapt()
    store.stage(torch.ones((2,)), {})
    with pytest.raises(RuntimeError, match="staged twice|without"):
        store.stage(torch.ones((2,)), {})
    with pytest.raises(RuntimeError, match="pending"):
        store.begin_adapt()
    store.drop_staged()
    store.begin_adapt()
    assert store.version == 0


def test_read_rows_tags_generation():
    store = T.DoubleBufferedStore(torch.arange(8.0).reshape(4, 2), {})
    rows, version = store.read_rows(torch.tensor([1, 3]))
    assert version == 0
    np.testing.assert_array_equal(rows.numpy(), [[2., 3.], [6., 7.]])


# ------------------------------------------------------------- server
def _server(**kw):
    init_fn, adapt_fn = _make_step()
    cfg = dict(batch_ids=16, max_delay_s=1e-3, queue_cap=4)
    cfg.update(kw)
    return T.AdaptServer(_table(5), init_fn(), adapt_fn,
                         T.ServerConfig(**cfg))


def test_completion_futures():
    srv = _server(batch_ids=64, queue_cap=64)
    reqs = [_req(T, [i, i + 1], t=i * 1e-4, seed=i) for i in range(4)]
    comps = [srv.submit(r) for r in reqs]
    assert all(not c.done() for c in comps)
    with pytest.raises(RuntimeError, match="pending"):
        comps[0].result()
    assert comps[0].latency_s is None
    srv.drain()
    assert all(c.done() and not c.shed for c in comps)
    assert all(c.result() == srv.store.version for c in comps)
    assert all(c.latency_s >= 0.0 for c in comps)


def test_slow_arrivals_dispatch_on_deadline():
    srv = _server(batch_ids=64, max_delay_s=1e-3, queue_cap=64)
    T.replay(srv, [_req(T, [i], t=i * 1.0, seed=i) for i in range(3)],
             warmup=False)
    assert srv.n_batches == 3 and srv.n_done == 3 and srv.n_shed == 0


def test_backpressure_sheds_at_queue_cap():
    import time as _time
    srv = _server(queue_cap=2, max_delay_s=1e-3)
    inner = srv._adapt

    def slow(*a):
        _time.sleep(0.02)
        return inner(*a)
    srv._adapt = slow
    reqs = [_req(T, [i % N_ROWS], t=i * 1e-4, seed=i) for i in range(30)]
    comps = T.replay(srv, reqs, warmup=False)
    srv.drain()
    shed = [c for c in comps if c.shed]
    assert shed, "expected overload to shed"
    assert srv.n_shed == len(shed)
    assert srv.n_done + srv.n_shed == srv.n_submitted == 30
    with pytest.raises(T.RequestShed):
        shed[0].result()
    assert srv.shed_rate > 0 and all(c.done() for c in comps)


def test_metrics_record_schema_and_writer(tmp_path):
    srv = _server(batch_ids=64, queue_cap=64)
    T.replay(srv, [_req(T, [1, 2], seed=9)], warmup=False)
    rec = srv.metrics_record(offered_load=100.0)
    assert rec["adapt_ms"]["count"] == 1
    assert rec["n_batches"] == 1 and rec["shed_rate"] == 0.0
    assert rec["slo_p99_ms"] == T.ServerConfig().slo_p99_ms
    with MetricsWriter(tmp_path, run_meta={"workload": "serve"}) as w:
        srv.emit(w, offered_load=100.0)
    for validate in (validate_file, j_validate_file):
        recs = validate(tmp_path / "metrics.jsonl")
        assert [r["kind"] for r in recs] == ["meta", "serve"]
        assert recs[1]["offered_load"] == 100.0


def test_reads_lock_free_during_replay():
    srv = _server(batch_ids=16, queue_cap=64)
    reqs = [_req(T, [i % N_ROWS for i in range(j, j + 4)], t=j * 1e-4,
                 seed=j) for j in range(8)]
    v0 = srv.store.version
    for r in reqs:
        srv.submit(r)
        rows, version = srv.read_rows(torch.tensor([0, 1]))
        assert rows.shape == (2, DIM) and version >= v0
    srv.drain()
    assert srv.store.version == srv.n_batches


class _FakeClock:
    """A stand-in for the ``time`` module: ``perf_counter`` steps through
    a fixed cycle of increments, so each batch's service time is the
    same in both packages."""

    STEPS = (1e-4, 3e-3, 2e-4, 8e-4, 1e-4, 6e-3)

    def __init__(self):
        self.t, self.i = 100.0, 0

    def perf_counter(self):
        self.t += self.STEPS[self.i % len(self.STEPS)]
        self.i += 1
        return self.t


@pytest.mark.parametrize("arm", ["countmin", "dense"])
def test_replay_matches_reference(arm, monkeypatch):
    cfg = dict(n_requests=160, n_users=16, n_rows=N_ROWS, dim=DIM,
               ids_per_request=8, offered_load=2000.0, seed=3)
    scfg = dict(batch_ids=32, max_delay_s=2e-3, queue_cap=6)
    table0 = _table(7).numpy()
    monkeypatch.setattr(jserver_mod, "time", _FakeClock())
    monkeypatch.setattr(tserver_mod, "time", _FakeClock())
    if arm == "countmin":
        jinit, jadapt = J.make_online_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9)
        tinit, tadapt = _make_step()
    else:
        jinit, jadapt = J.make_dense_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9)
        tinit, tadapt = T.make_dense_adapt_step(N_ROWS, DIM, lr=1e-2, b2=0.9,
                                                device="cpu")
    jsrv = J.AdaptServer(jnp.asarray(table0.copy()), jinit(), jadapt,
                         J.ServerConfig(**scfg))
    tsrv = T.AdaptServer(torch.from_numpy(table0.copy()), tinit(), tadapt,
                         T.ServerConfig(**scfg))
    jc = J.replay(jsrv, J.make_trace(J.TraceConfig(**cfg)))
    tc = T.replay(tsrv, T.make_trace(T.TraceConfig(**cfg)))
    assert tsrv.n_batches == jsrv.n_batches > 5
    assert tsrv.n_shed == jsrv.n_shed > 0
    assert [c.state for c in tc] == [c.state for c in jc]
    assert [c.version for c in tc] == [c.version for c in jc]
    assert [c.t_done for c in tc] == [c.t_done for c in jc]
    keys = ("n_requests", "n_batches", "n_shed", "shed_rate", "queue_depth",
            "slo_p99_ms", "request_ms")
    jrec, trec = jsrv.metrics_record(), tsrv.metrics_record()
    assert {k: trec[k] for k in keys} == {k: jrec[k] for k in keys}
    assert trec["adapt_ms"]["count"] == jrec["adapt_ms"]["count"]
    jsnap, tsnap = jsrv.store.read(), tsrv.store.read()
    assert tsnap.version == jsnap.version == jsrv.n_batches
    np.testing.assert_allclose(tsnap.table.numpy(), np.asarray(jsnap.table),
                               **REPLAY_TOL)
    np.testing.assert_allclose(tsnap.opt_state["v"].numpy(),
                               np.asarray(jsnap.opt_state["v"]), **REPLAY_TOL)
    assert int(tsnap.opt_state["step"]) == int(jsnap.opt_state["step"])


# ------------------------------------------------------------- store resolution
def _spy_lookup(monkeypatch):
    from repro_torch.kernels import registry
    calls = []
    orig = registry.lookup

    def spy(kind, op, backend=None, device=None):
        calls.append((kind, op, backend))
        return orig(kind, op, backend, device)
    monkeypatch.setattr(registry, "lookup", spy)
    return calls


def _adapt_once(init_fn, adapt_fn):
    ids = torch.tensor([1, 2, 3, 1], dtype=torch.int32)
    return adapt_fn(torch.zeros((N_ROWS, DIM)), init_fn(), ids,
                    torch.ones((4, DIM)) * 0.1)


def _cms(backend=None, cleaning=None):
    hp = SketchHParams()
    return CountMinStore(spec=hp.spec("serve_adapt", (N_ROWS, DIM),
                                      signed=False),
                         shape=(N_ROWS, DIM), backend=backend,
                         cleaning=cleaning)


def test_v_store_backend_wins_over_hparams(monkeypatch):
    calls = _spy_lookup(monkeypatch)
    _adapt_once(*_make_step(hparams=SketchHParams(backend="ref"),
                            v_store=_cms(backend="xla")))
    assert ("pair", "adam_rows", "xla") in calls


def test_store_backend_overrides_planner_resolved_store(monkeypatch):
    calls = _spy_lookup(monkeypatch)
    table, _ = _adapt_once(*_make_step(v_store=_cms(backend="xla"),
                                       store_backend="stream"))
    assert ("pair", "adam_rows", "stream") in calls
    assert not any(b == "xla" for _, _, b in calls)
    assert float(table.abs().sum()) > 0.0


def test_hparams_backend_used_when_store_carries_none(monkeypatch):
    calls = _spy_lookup(monkeypatch)
    _adapt_once(*_make_step(hparams=SketchHParams(backend="ref"),
                            v_store=_cms()))
    assert ("pair", "adam_rows", "ref") in calls


def test_cms_cleaning_fires_across_adapt_calls(monkeypatch):
    clean_calls = []
    orig = CountMinStore.clean

    def spy(self, state, step):
        clean_calls.append(int(step))
        return orig(self, state, step)
    monkeypatch.setattr(CountMinStore, "clean", spy)

    def run(v_store):
        init_fn, adapt_fn = _make_step(v_store=v_store, store_backend="xla")
        table, state = torch.zeros((N_ROWS, DIM)), init_fn()
        ids = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
        for _ in range(4):
            table, state = adapt_fn(table, state, ids,
                                    torch.ones((4, DIM)) * 0.1)
        return state

    s_clean = run(_cms(cleaning=CleaningSchedule(alpha=0.1, every=2)))
    assert clean_calls == [1, 2, 3, 4]       # the hook runs every update
    s_plain = run(_cms())
    mass = lambda s: float(s["v"].abs().sum())  # noqa: E731
    assert mass(s_clean) < 0.5 * mass(s_plain)


def test_dp_only_args_rejected_without_dp_axis():
    with pytest.raises(ValueError, match="error_feedback"):
        _make_step(error_feedback=True)
    with pytest.raises(ValueError, match="dir_clip"):
        _make_step(dir_clip=5.0)
    with pytest.raises(ValueError, match="dir_clip"):
        _make_step(dir_clip=None)     # explicit None is still explicit
    init_fn, _ = _make_step(dp_axis="dp", error_feedback=True, dir_clip=5.0)
    assert init_fn()["residual"] is not None   # the dp path takes both
    _adapt_once(*_make_step())        # defaults stay valid


def test_exports_match_reference_minus_model_serving():
    want = {n for n in dir(J) if not n.startswith("_")} - {
        "make_serve_step", "cache_factory", "ServeStep", "batcher",
        "buffer", "server", "steps", "traffic"}
    got = {n for n in dir(T) if not n.startswith("_")} - {
        "batcher", "buffer", "server", "steps", "traffic"}
    assert want <= got, want - got
