"""The port's sharded step across processes: ``torch.distributed`` on
gloo, four ranks as a 2 × 2 (data × model) grid of ``new_group``
sub-groups (``process_group_mesh``), against ``ReplicaMesh((2, 2))`` in
this process.

One spawn for the module (the ``spawn`` start method, a ``file://``
rendezvous in a temporary directory, a 60 s process-group timeout) runs
in each rank the grid's collectives and 3 steps of
``make_sparse_embedding_step(sketch_shards=2, dp_axis=, shard_axis=)``
under both layouts, each rank holding its shard's slabs.  Each rank saves
its table and slabs after every step.  The ranks' tables must be equal,
the slabs of one shard equal across the data axis, and every rank's bits
equal to the same replica's in ``ReplicaMesh((2, 2))``: a psum of two
replicas is the same float in either order.  The spawn has its own
deadline (``SPAWN_TIMEOUT``).  This file imports no JAX.
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
from repro_torch.distributed import (ReplicaMesh, process_group_mesh,
                                     shard_state)
from repro_torch.train.steps import make_sparse_embedding_step

GRID, N, D, K, STEPS, LR = (2, 2), 512, 16, 32, 3, 1e-2
WORLD = GRID[0] * GRID[1]
HP = SketchHParams(compression=2.0, width_multiple=64)
CASES = [("width", True), ("hash", False)]      # (layout, error feedback)
SPAWN_TIMEOUT = 180.0                           # s for the whole spawn


def _batches(seed):
    """Per step: (ids (dp, K) int32, rows (dp, K, D) f32)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, N // 2, (GRID[0], K)).astype(np.int32),
             rng.randn(GRID[0], K, D).astype(np.float32))
            for _ in range(STEPS)]


def _table0():
    rng = np.random.RandomState(0)
    return torch.tensor((rng.randn(N, D) / np.sqrt(D)).astype(np.float32))


def _replica_runs(data, model, rank):
    """What replica ``rank`` (at (rank // 2, rank % 2)) holds after each
    step of each case, its collectives the two given axes."""
    d, s = divmod(rank, GRID[1])
    out = {}
    for layout, fb in CASES:
        _, step, opt = make_sparse_embedding_step(
            N, D, lr=LR, hparams=HP, sketch_shards=GRID[1],
            shard_layout=layout, dp_axis=data, shard_axis=model,
            error_feedback=fb, device="cpu")
        table, state = _table0(), shard_state(opt.init(), GRID[1], s)
        steps = []
        for ids, rows in _batches(int(fb)):
            table, state = step(table, state, torch.tensor(ids[d]),
                                torch.tensor(rows[d]))
            steps.append((table.clone(), {k: v.clone() if isinstance(
                v, torch.Tensor) else v for k, v in state.items()}))
        out[layout] = steps
    return out


def _worker(rank, rdzv, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        data, model = process_group_mesh(GRID)
        x = torch.tensor([float(rank)])
        res = {"axes": (data.size, data.rank, model.size, model.rank),
               "data_psum": data.psum(x), "model_psum": model.psum(x),
               "runs": _replica_runs(data, model, rank)}
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_sharded")
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
    """The same runs through ``ReplicaMesh((2, 2))`` in this process."""
    torch.set_num_threads(1)
    mesh = ReplicaMesh(GRID, timeout=120.0)
    return mesh.run(lambda r: _replica_runs(mesh.axis("data"),
                                            mesh.axis("model"), r),
                    [(r,) for r in range(WORLD)])


def _same(a, b, what):
    ta, sa = a
    tb, sb = b
    assert torch.equal(ta, tb), f"{what}: table"
    for k in ("step", "m", "v", "residual"):
        x, y = sa[k], sb[k]
        assert (x is None) == (y is None), f"{what}: {k}"
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {k}"


def test_gloo_grid_axes(ranks):
    for r, res in enumerate(ranks):
        d, s = divmod(r, GRID[1])
        assert res["axes"] == (GRID[0], d, GRID[1], s)
        assert float(res["data_psum"]) == s + (GRID[1] + s)
        assert float(res["model_psum"]) == 2 * GRID[1] * d + 1


@pytest.mark.parametrize("layout", [c[0] for c in CASES])
def test_gloo_grid_replicas_agree(ranks, layout):
    """Every rank's table alike; a shard's slabs alike across the data
    axis; the two shards' slabs differ (each holds its own)."""
    for i in range(STEPS):
        for r in range(1, WORLD):
            assert torch.equal(ranks[r]["runs"][layout][i][0],
                               ranks[0]["runs"][layout][i][0])
        for s in range(GRID[1]):
            _same(ranks[s]["runs"][layout][i],
                  ranks[GRID[1] + s]["runs"][layout][i], f"shard {s}")
    v0 = ranks[0]["runs"][layout][-1][1]["v"]
    v1 = ranks[1]["runs"][layout][-1][1]["v"]
    assert not torch.equal(v0, v1)


@pytest.mark.parametrize("layout", [c[0] for c in CASES])
def test_gloo_grid_equals_replica_mesh(ranks, model, layout):
    for r in range(WORLD):
        for i in range(STEPS):
            _same(ranks[r]["runs"][layout][i], model[r][layout][i],
                  f"{layout}: gloo rank {r} step {i + 1} against "
                  f"ReplicaMesh")
    table, state = ranks[0]["runs"][layout][-1]
    assert int(state["step"]) == STEPS
    assert not torch.equal(table, _table0()) and torch.isfinite(table).all()
