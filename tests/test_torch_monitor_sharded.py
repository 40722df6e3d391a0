"""The table monitors of ``--metrics-dir`` under ``--sketch-shards``.

Each replica of a sharded run holds one width slab of every sketch, so
``launch.train.run_sparse_embedding`` hands its ``TableMonitor`` the
global sketches, gathered by every replica at each log boundary
(``sharding.global_tree``); replica 0 writes the records and the others
follow (``RunObserver(None)``).  Both layouts run on ``ReplicaMesh``
threads in this process and as two gloo ranks (one spawn for the
module, the ``spawn`` start method, a ``file://`` rendezvous, a 60 s
process-group timeout and its own deadline ``SPAWN_TIMEOUT``, which a
replica missing a gather would overrun).  For every run:

  * the file validates, with one ``table`` record a boundary (steps 5
    and 10 of 10);
  * each ``table`` record equals to the bit what one fresh monitor
    computes in one thread on the state gathered at that boundary;
  * the field set and values are the reference's: ``repro.obs``'s
    monitor over the same stores, on the same gathered state (rtol
    1e-5, atol 1e-6, the records' tolerance in ``test_torch_obs.py``);
  * the gloo ranks' records equal the threads' to the bit.

The width layout's sketches are the unsharded sketches, so its float
fields are also held within rtol 1e-4 of the same flags without
sharding: ``--dp`` in a gloo group of one, the data-parallel step whose
family the sharded step is.  The hash layout bakes the shard count into every bucket,
so it has no unsharded counterpart.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.optimizers import SketchHParams
from repro_torch.distributed import ReplicaMesh
from repro_torch.launch import train as TL
from repro_torch.obs import validate_file

SPAWN_TIMEOUT = 240.0           # s for the spawn
STEPS, LOG_EVERY = 10, 5
SPARSE = ["--workload", "sparse_embedding", "--sparse-rows", "4096",
          "--sparse-dim", "32", "--batch", "16", "--seq", "16",
          "--lr", "0.01", "--steps", str(STEPS), "--log-every",
          str(LOG_EVERY), "--probe-rows", "16", "--device", "cpu"]
LAYOUTS = ("width", "hash")


def _argv(out, layout, shards=2):
    extra = ["--sketch-shards", str(shards)] if shards > 1 else []
    if layout == "hash":
        extra += ["--shard-layout", "hash"]
    return SPARSE + extra + ["--metrics-dir", str(out)]


class _Capture:
    """Keeps, on replica 0, the launcher's monitor and a copy of every
    state its getter gathered; ``replica()`` gives this thread's or
    process's rank."""

    def __init__(self, replica):
        self.replica, self.monitors, self.gathered = replica, [], []

    @contextlib.contextmanager
    def installed(self):
        make, gather = TL.make_observer, TL.shd.global_tree
        cap = self

        def make_observer(args, meta, monitors=(), *a, **kw):
            if cap.replica() == 0:
                cap.monitors.extend(monitors)
            return make(args, meta, monitors, *a, **kw)

        def global_tree(tree, placement):
            out = gather(tree, placement)
            if cap.replica() == 0:
                cap.gathered.append(_clone(out))
            return out

        TL.make_observer, TL.shd.global_tree = make_observer, global_tree
        try:
            yield self
        finally:
            TL.make_observer, TL.shd.global_tree = make, gather


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _one_monitor(mon, gathered, steps):
    """The records one fresh copy of ``mon`` computes on each gathered
    state, at its step, through the JSON the writer writes."""
    out, last = [], 0
    for st, step in zip(gathered, steps):
        fresh = dataclasses.replace(mon, getter=None)
        fresh._keys = fresh._host = fresh._pending = None
        fresh._last_step = last
        fresh.collect(st, step)
        rec = fresh.flush()
        out.append(json.loads(json.dumps(rec)))
        last = step
    return out


def _table_records(out_dir):
    recs = validate_file(Path(out_dir) / "metrics.jsonl")
    return [{k: v for k, v in r.items() if k not in ("schema", "kind")}
            for r in recs if r["kind"] == "table"]


def _run_and_check(cap, run):
    """Run ``run()`` (``cap`` installed); on replica 0 return ``(exit
    code, the monitor's records on the gathered states, the gathered
    states)``."""
    rc = run()
    if cap.replica() != 0:
        return rc, None, None
    steps = [LOG_EVERY * (i + 1) for i in range(len(cap.gathered))]
    return rc, _one_monitor(cap.monitors[0], cap.gathered, steps), \
        cap.gathered


def _worker(rank, world, rdzv, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    res = {}
    try:
        for layout in LAYOUTS:
            out = Path(root) / f"gloo_{layout}"
            cap = _Capture(dist.get_rank)
            with contextlib.redirect_stdout(io.StringIO()), \
                    cap.installed():
                res[layout] = _run_and_check(
                    cap, lambda: TL.main(_argv(out, layout)))
        torch.save(res, Path(root) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    root = tmp_path_factory.mktemp("monitor_gloo")
    ctx = mp.start_processes(_worker, args=(2, str(root / "rdzv"),
                                            str(root)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in "
                            f"{SPAWN_TIMEOUT} s: a replica missed a gather")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    res = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    return root, res


@pytest.fixture(scope="module")
def threads(tmp_path_factory):
    """Both layouts on ``ReplicaMesh((1, 2))`` threads, and the width
    flags without sharding in this thread."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("monitor_threads")
    out = {}
    for layout in LAYOUTS:
        d = root / f"threads_{layout}"
        args = TL.parser().parse_args(_argv(d, layout))
        shape, grid = TL.grid_shapes(args, 2)
        mesh = ReplicaMesh(shape, timeout=120.0)
        cap = _Capture(lambda: mesh.rank)

        def replica():
            a = argparse.Namespace(**vars(args))
            a.rank = mesh.rank
            return _run_and_check(cap, lambda: TL.run_sparse_embedding(
                a, torch.device("cpu"), mesh, grid))

        # one redirect and one patch for both threads
        with contextlib.redirect_stdout(io.StringIO()), cap.installed():
            out[layout] = (d, mesh.run(replica, [()] * 2))
    # the sharded step is the data-parallel step's family (both clamp the
    # direction, ``dir_clip``; the single-device step does not), so the
    # same flags without sharding are ``--dp`` in a gloo group of one
    plain = root / "unsharded"
    dist.init_process_group("gloo", init_method=f"file://{root / 'pg'}",
                            rank=0, world_size=1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = TL.main(_argv(plain, "width", shards=1) + ["--dp"])
    finally:
        dist.destroy_process_group()
    return out, (rc, plain)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_threads_records_are_the_gathered_tables(threads, layout):
    out, _ = threads
    d, res = out[layout]
    (rc0, mine, gathered), (rc1, none, _) = res
    assert rc0 == rc1 == 0 and none is None
    recs = _table_records(d)
    assert [r["step"] for r in recs] == [LOG_EVERY, STEPS]
    # the gathered sketches are whole, not a replica's slab
    _m, v_st = TL.sparse_embedding_stores(
        4096, 32, hparams=SketchHParams(compression=5.0), sketch_shards=2,
        shard_layout=layout)
    assert len(gathered) == 2
    for st in gathered:
        for k in ("m", "v"):
            assert tuple(st[k].shape) == tuple(v_st.spec.shape)
    assert recs == mine


@pytest.mark.parametrize("layout", LAYOUTS)
def test_threads_match_the_reference_monitor(threads, layout):
    """``repro.obs.TableMonitor`` over the reference's stores for the same
    flags, on the same gathered states: the same fields, the same
    values within rtol 1e-5."""
    import jax.numpy as jnp
    from repro.core.optimizers import SketchHParams as RefHParams
    from repro.obs import TableMonitor, TableProbe, predicted_table_errors
    from repro.train.steps import sparse_embedding_stores

    out, _ = threads
    d, res = out[layout]
    _rc, _mine, gathered = res[0]
    m_st, v_st = sparse_embedding_stores(
        4096, 32, hparams=RefHParams(compression=5.0), sketch_shards=2,
        shard_layout=layout)
    mon = TableMonitor(path="sparse_embedding", m_store=m_st, v_store=v_st,
                       probe=TableProbe.for_table("sparse_embedding", 4096,
                                                  k=16),
                       predicted=predicted_table_errors(m_st, v_st, 4096,
                                                        alpha=1.1))

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return jnp.asarray(t.numpy().copy())
        return t

    ref = []
    for st, step in zip(gathered, (LOG_EVERY, STEPS)):
        mon.collect(to_jax(st), step)
        ref.append(json.loads(json.dumps(mon.flush())))
    recs = _table_records(d)
    for got, want in zip(recs, ref):
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                assert got[k] == v, k


def test_width_records_match_the_unsharded_run(threads):
    out, (rc, plain) = threads
    assert rc == 0
    base = _table_records(plain)
    got = _table_records(out["width"][0])
    assert [r["step"] for r in base] == [r["step"] for r in got]
    for g, b in zip(got, base):
        # a sharded store adds its slabs' occupancy extremes
        assert set(g) - set(b) == {f"{m}_shard_occ_{e}" for m in "mv"
                                   for e in ("min", "max")}
        for k, v in b.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gloo_records_are_the_gathered_tables(gloo, layout):
    root, res = gloo
    (rc0, mine, _g), (rc1, none, _) = res[0][layout], res[1][layout]
    assert rc0 == rc1 == 0 and none is None
    recs = _table_records(root / f"gloo_{layout}")
    assert [r["step"] for r in recs] == [LOG_EVERY, STEPS]
    assert recs == mine


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gloo_records_equal_the_threads(gloo, threads, layout):
    root, _res = gloo
    out, _ = threads
    assert _table_records(root / f"gloo_{layout}") == \
        _table_records(out[layout][0])


def test_follower_writes_nothing(tmp_path):
    """A follower reads its monitors' states at the writer's boundaries
    (here a counting getter) and writes no file."""
    from repro_torch.obs import RunObserver, TableMonitor
    seen = []
    mon = TableMonitor(path="t", getter=lambda st: seen.append(st) or {})
    obs = RunObserver(None, monitors=[mon], log_every=5)
    for step in range(1, 13):
        obs.on_step(step, {"loss": 1.0, "time_s": 0.1}, step)
    obs.close(12, 12)
    assert seen == [5, 10, 12]
    assert not list(tmp_path.iterdir())
