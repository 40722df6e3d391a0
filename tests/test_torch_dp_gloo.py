"""The port's data-parallel steps across processes: ``torch.distributed``
on gloo, world size 2, against the one-process ``ReplicaGroup`` model.

One spawn for the module (``torch.multiprocessing``, the ``spawn``
start method, a ``file://`` rendezvous in a temporary directory) runs in
each rank the collectives of ``ProcessGroupAxis`` and 5 steps of the
sparse-embedding, serve-fleet and extreme ``dp_axis`` steps, the axis
given as the string ``"data"`` (the default process group, as the
launcher will call it).  Each rank saves what it holds after every
step.  At every step the ranks' table and state bits must be equal, and
equal to the same steps run by ``ReplicaGroup(2)`` in this process: a
sum of two replicas is the same float in either order, so the routes
agree to the bit.

The spawn has its own deadline (``SPAWN_TIMEOUT``): a hung rendezvous
fails the module instead of running on.  This file imports no JAX.
"""
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.optimizers import SketchHParams
from repro_torch.data import pipeline as tp
from repro_torch.distributed import collectives as col
from repro_torch.serve.steps import make_online_adapt_step
from repro_torch.train import extreme as tx
from repro_torch.train.steps import make_sparse_embedding_step

WORLD, N, D, K, STEPS, LR = 2, 512, 16, 32, 5, 1e-2
HP = SketchHParams(compression=2.0, width_multiple=64)
SPARSE_CASES = [(True, True), (False, False)]     # (track_m, feedback)
X_KW = dict(n_classes=50_000, n_meta=4096, n_features=2048, dim=16, nnz=8,
            n_negatives=64)
X_BATCH = 16                                      # global; 8 a rank
SPAWN_TIMEOUT = 180.0                             # s for the whole spawn


def _batches(seed):
    """Per step: (ids (WORLD, K) int32, rows (WORLD, K, D) f32)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, N // 2, (WORLD, K)).astype(np.int32),
             rng.randn(WORLD, K, D).astype(np.float32))
            for _ in range(STEPS)]


def _table0(seed):
    rng = np.random.RandomState(seed)
    return torch.tensor((rng.randn(N, D) / np.sqrt(D)).astype(np.float32))


def _extreme_batches():
    cfg = tx.MachConfig(**X_KW)
    stream = tx.MetaStream(tp.ExtremeStream(cfg.data_config(X_BATCH)),
                           cfg.class_maps()[0], device="cpu")
    per = X_BATCH // WORLD
    return [[{"features": b["features"][r * per:(r + 1) * per],
              "labels": b["labels"][r * per:(r + 1) * per],
              "negatives": b["negatives"]} for r in range(WORLD)]
            for b in (stream.batch(i) for i in range(STEPS))]


def _clone(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def _replica_runs(axis, rank):
    """What one replica holds after each step, every step run through
    ``axis``."""
    out = {}
    for track_m, fb in SPARSE_CASES:
        _, step, opt = make_sparse_embedding_step(
            N, D, lr=LR, hparams=HP, track_first_moment=track_m,
            dp_axis=axis, error_feedback=fb, device="cpu")
        table, state, steps = _table0(0), opt.init(), []
        for ids, rows in _batches(int(fb)):
            table, state = step(table, state, torch.tensor(ids[rank]),
                                torch.tensor(rows[rank]))
            steps.append((table.clone(), _clone(state)))
        out[f"sparse{int(track_m)}{int(fb)}"] = steps
    init, adapt = make_online_adapt_step(N, D, lr=LR, hparams=HP,
                                         dp_axis=axis, error_feedback=True,
                                         device="cpu")
    table, state, steps = _table0(1), init(), []
    for ids, rows in _batches(2):
        table, state = adapt(table, state, torch.tensor(ids[rank]),
                             torch.tensor(rows[rank]))
        steps.append((table.clone(), _clone(state)))
    out["serve"] = steps
    cfg = tx.MachConfig(**X_KW)
    init_fn, step, opts = tx.make_extreme_step(
        cfg, optimizer="cs_adam", lr=LR, dp_axis=axis, error_feedback=True,
        device="cpu")
    params = init_fn(torch.Generator().manual_seed(3))
    state = {p: o.init() for p, o in opts.items()}
    steps = []
    for shards in _extreme_batches():
        params, state, m = step(params, state, shards[rank])
        steps.append(([t["table"].clone() for t in params.values()],
                      {p: _clone(s) for p, s in state.items()}, dict(m)))
    out["extreme"] = steps
    return out


def _worker(rank, rdzv, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        axis = col.ProcessGroupAxis()
        res = {"size": axis.size, "rank": axis.rank,
               "psum": axis.psum(torch.tensor([0.1, 2.0]) * (rank + 1)),
               "pmean": axis.pmean(torch.tensor(3.0 + rank)),
               "gather": axis.all_gather(torch.tensor([rank, 7],
                                                      dtype=torch.int32)),
               "runs": _replica_runs("data", rank)}
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_worker, args=(str(tmp / "rdzv"), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in "
                            f"{SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def model():
    """The same runs through ``ReplicaGroup(2)`` in this process."""
    torch.set_num_threads(1)
    g = col.ReplicaGroup(WORLD, timeout=120.0)
    return g.run(lambda: _replica_runs(g, g.rank), [()] * WORLD)


def _leaves(x, prefix=""):
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_leaves(x[k], f"{prefix}/{k}"))
        return out
    if isinstance(x, (list, tuple)):
        out = {}
        for i, v in enumerate(x):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: x}


def _assert_same_bits(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys(), what
    for path in la:
        x, y = la[path], lb[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {path}"
        else:
            assert x == y, f"{what} {path}"


def test_gloo_collectives(ranks):
    for r, res in enumerate(ranks):
        assert (res["size"], res["rank"]) == (WORLD, r)
        want = torch.tensor([0.1, 2.0]) * 1 + torch.tensor([0.1, 2.0]) * 2
        assert torch.equal(res["psum"], want)
        assert torch.equal(res["pmean"], torch.tensor(3.5))
        assert torch.equal(res["gather"],
                           torch.tensor([[0, 7], [1, 7]], dtype=torch.int32))


@pytest.mark.parametrize("run", ["sparse11", "sparse00", "serve", "extreme"])
def test_gloo_ranks_equal_at_every_step(ranks, run):
    _assert_same_bits(ranks[0]["runs"][run], ranks[1]["runs"][run],
                      f"{run}: rank 0 against rank 1")


@pytest.mark.parametrize("run", ["sparse11", "sparse00", "serve", "extreme"])
def test_gloo_equals_replica_group(ranks, model, run):
    for r in range(WORLD):
        _assert_same_bits(ranks[r]["runs"][run], model[r][run],
                          f"{run}: gloo rank {r} against ReplicaGroup")


def test_gloo_runs_moved_the_state(ranks):
    assert len(ranks[0]["runs"]["sparse11"]) == STEPS
    table, state = ranks[0]["runs"]["sparse11"][-1]
    assert int(state["step"]) == STEPS
    assert not torch.equal(table, _table0(0))
    # each row's cross share is clipped at -g², so every bucket's banked
    # total stays >= -G_v and the injection drains the residual each step
    assert state["residual"] is not None
    assert torch.equal(state["residual"], torch.zeros_like(state["v"]))
    assert torch.isfinite(table).all()
