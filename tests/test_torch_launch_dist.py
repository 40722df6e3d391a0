"""The port's launcher across processes: ``repro_torch.launch.train.main``
in gloo ranks against the same workload on ``ReplicaMesh`` threads.

Two spawns for the module (the ``spawn`` start method, a ``file://``
rendezvous, a 60 s process-group timeout, the spawn its own deadline
``SPAWN_TIMEOUT``): two ranks run ``--workload sparse_embedding`` with
``--dp --error-feedback``, ``--sketch-shards 2`` and ``--sketch-shards 2
--shard-layout hash``; then four ranks run ``--dp --sketch-shards 2``,
resume the width-layout checkpoint onto ``--sketch-shards 4`` (the
reference's re-placement message) and try the hash-layout one there (the
reference's refusal, "bakes the shard count").  Each rank keeps its
final table and state (``Trainer.fit`` wrapped).

In this process the same commands run through
``launch.train.run_sparse_embedding`` on ``ReplicaMesh`` threads of the
same grid over the same global batches.  Every rank's table and state
must equal its thread's to the bit, and the exit codes and ``[train]``
lines agree.  The rank-0 checkpoints hold global leaves: the JAX
package's ``restore`` reads them, equal to the threads' joined slabs.
"""
import argparse
import contextlib
import io
import shutil
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import ReplicaMesh, join_slabs
from repro_torch.launch import train as TL

SPAWN_TIMEOUT = 240.0           # s for one spawn
SPARSE = ["--workload", "sparse_embedding", "--sparse-rows", "4096",
          "--sparse-dim", "32", "--batch", "16", "--seq", "16",
          "--lr", "0.01", "--ckpt-every", "5", "--device", "cpu"]
# (name, world size, flags, --ckpt-dir, checkpoint copied in first)
CASES = [("dp_fb", 2, ["--dp", "--error-feedback", "--steps", "10"],
          "dp", None),
         ("shards2", 2, ["--sketch-shards", "2", "--steps", "10"],
          "w", None),
         ("hash2", 2, ["--sketch-shards", "2", "--shard-layout", "hash",
                       "--steps", "10"], "h", None),
         ("dp_shards2", 4, ["--dp", "--sketch-shards", "2",
                            "--steps", "10"], "dps", None),
         ("replace4", 4, ["--sketch-shards", "4", "--steps", "15"],
          "w4", "w"),
         ("hash4", 4, ["--sketch-shards", "4", "--shard-layout", "hash",
                       "--steps", "15"], "h4", "h")]
REPLACED = ("[train] width-layout sketch state re-placed: 2 -> 4 shards "
            "(state bytes identical; slabs re-routed at restore)")


class _Kept:
    """``Trainer`` with its final state kept under ``key()``."""

    def __init__(self, key):
        self.key, self.states = key, {}

    def trainer(self):
        keep = self

        class Trainer(TL.Trainer):
            def fit(self, state):
                state = super().fit(state)
                keep.states[keep.key()] = (
                    state.params.clone(),
                    {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in state.opt_state.items()})
                return state
        return Trainer


def _run(fn, capture=True):
    """``(exit code or the error's text, stdout)`` of ``fn()``; threads
    share ``sys.stdout``, so they pass ``capture=False``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out) if capture \
            else contextlib.nullcontext():
        try:
            rc = fn()
        except ValueError as e:
            rc = f"ValueError: {e}"
    return rc, out.getvalue()


def _argv(root, name, flags, d):
    return SPARSE + flags + ["--ckpt-dir", str(Path(root) / d)]


def _worker(rank, world, rdzv, root, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    kept = _Kept(lambda: current[0])
    TL.Trainer = kept.trainer()
    res = {}
    try:
        for name, _w, flags, d, _src in CASES:
            if name not in names:
                continue
            current = [name]
            res[name] = _run(lambda: TL.main(_argv(root, name, flags, d)))
        res["states"] = kept.states
        torch.save(res, Path(root) / f"{'-'.join(names)}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(root, world, names):
    ctx = mp.start_processes(_worker, args=(world, str(root / f"rdzv{world}"),
                                            str(root), names),
                             nprocs=world, join=False, start_method="spawn")
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
    return [torch.load(root / f"{'-'.join(names)}.rank{r}.pt",
                       weights_only=False) for r in range(world)]


def _copy_sources(root):
    for _n, _w, _f, d, src in CASES:
        if src is not None and (root / src).exists():
            shutil.copytree(root / src, root / d)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch_gloo")
    out = {}
    for world in (2, 4):
        if world == 4:
            _copy_sources(root)
        names = [n for n, w, *_ in CASES if w == world]
        got = _spawn(root, world, names)
        for name in names:
            out[name] = [(g[name], g["states"].get(name)) for g in got]
    return root, out


@pytest.fixture(scope="module")
def threads(tmp_path_factory):
    """The same commands on ``ReplicaMesh`` threads of each grid."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("launch_threads")
    out = {}
    lock = threading.Lock()
    for world in (2, 4):
        if world == 4:
            _copy_sources(root)
        for name, w, flags, d, _src in CASES:
            if w != world:
                continue
            args = TL.parser().parse_args(_argv(root, name, flags, d))
            shape, grid = TL.grid_shapes(args, world)
            mesh = ReplicaMesh(shape, timeout=120.0)
            kept = _Kept(lambda: mesh.rank)
            trainer = kept.trainer()

            def replica():
                a = argparse.Namespace(**vars(args))
                a.rank = mesh.rank
                return _run(lambda: TL.run_sparse_embedding(
                    a, torch.device("cpu"), mesh, grid), capture=False)

            with lock:
                orig, TL.Trainer = TL.Trainer, trainer
                try:
                    res = mesh.run(replica, [()] * mesh.size)
                finally:
                    TL.Trainer = orig
            out[name] = [(res[r], kept.states.get(r))
                         for r in range(mesh.size)]
    return root, out


def _equal(a, b):
    (ta, sa), (tb, sb) = a, b
    return torch.equal(ta, tb) and set(sa) == set(sb) and all(
        (sa[k] is None and sb[k] is None) or torch.equal(
            torch.as_tensor(sa[k]), torch.as_tensor(sb[k])) for k in sa)


def _line(stdout):
    return [l for l in stdout.splitlines()
            if l.startswith("[train] workload=")][-1]


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[0] != "hash4"])
def test_ranks_equal_their_threads(ranks, threads, name):
    procs, thr = ranks[1][name], threads[1][name]
    assert len(procs) == len(thr)
    for r, ((prc, pout), pstate) in enumerate(procs):
        (trc, _tout), tstate = thr[r]
        assert prc == trc, (name, r)
        assert pstate is not None and _equal(pstate, tstate), (name, r)
    (rc0, out0), _ = procs[0]
    assert rc0 == 0, out0
    line = _line(out0)
    assert f"dp={CASES_BY_NAME[name]['dp']}" in line
    assert f"shards={CASES_BY_NAME[name]['shards']}" in line
    assert all(out == "" for (_rc, out), _s in procs[1:])   # rank 0 prints


CASES_BY_NAME = {
    "dp_fb": {"dp": True, "shards": "1(width)"},
    "shards2": {"dp": False, "shards": "2(width)"},
    "hash2": {"dp": False, "shards": "2(hash)"},
    "dp_shards2": {"dp": True, "shards": "2(width)"},
    "replace4": {"dp": False, "shards": "4(width)"}}


def test_width_layout_replaces_onto_four_shards(ranks):
    (rc, out), state = ranks[1]["replace4"][0]
    assert REPLACED in out.splitlines()
    assert "steps=15" in _line(out)
    assert state[1]["v"].shape[1] * 4 == ranks[1]["shards2"][0][1][1][
        "v"].shape[1] * 2


def test_hash_layout_refuses_another_shard_count(ranks, threads):
    for (rc, _out), state in ranks[1]["hash4"] + threads[1]["hash4"]:
        assert isinstance(rc, str) and "bakes the shard count" in rc
        assert state is None


@pytest.mark.parametrize("name", ["dp_fb", "shards2", "dp_shards2",
                                  "replace4"])
def test_rank0_checkpoint_loads_in_the_jax_package(ranks, threads, name):
    from repro.checkpoint import store as JS
    d = [c[3] for c in CASES if c[0] == name][0]
    like = {"params": 0, "opt_state": {
        k: 0 for k, v in threads[1][name][0][1][1].items() if v is not None}}
    step, tree = JS.restore(ranks[0] / d, like)
    assert step == int(threads[1][name][0][1][1]["step"])
    shards = int(CASES_BY_NAME[name]["shards"][0])
    states = [s for _o, s in threads[1][name]][:shards]
    table = states[0][0]
    full = join_slabs([s[1] for s in states])
    np.testing.assert_array_equal(np.asarray(tree["params"]), table.numpy())
    for k, v in full.items():
        if k != "step" and v is not None:
            np.testing.assert_array_equal(np.asarray(tree["opt_state"][k]),
                                          v.numpy())
