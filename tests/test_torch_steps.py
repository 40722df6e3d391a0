"""End-to-end parity of the port's train and serve steps with JAX.

Both packages start from one state (``repro_torch.convert``) and take the
same duplicate-heavy batches of ids; the gradient rows are ``table[ids] -
target[ids]``, each package on its own table, as ``launch/train.py`` of
the reference makes them.  Tolerance rtol=1e-4, atol=1e-5 after 30 steps:
the per-step differences are single ulps (FMA contraction and the float64
bias-correction power, see test_torch_backends.py), and the median and
the min are continuous, so they stay small along the trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cleaning import CleaningSchedule as JClean
from repro.core.optimizers import SketchHParams as JHP
from repro.serve.steps import make_online_adapt_step as j_adapt
from repro.train.steps import make_sparse_embedding_step as j_make
from repro_torch import convert
from repro_torch.core.cleaning import CleaningSchedule as TClean
from repro_torch.core.optimizers import SketchHParams as THP
from repro_torch.core.stores import CountMinStore, CountSketchStore, StoreTree
from repro_torch.serve.steps import make_online_adapt_step as t_adapt
from repro_torch.train.steps import make_sparse_embedding_step as t_make

N, D, K = 1024, 128, 64
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _batches(steps, seed=0, hi=N // 8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, hi, K).astype(np.int32) for _ in range(steps)]


def _start(seed=0):
    rng = np.random.RandomState(seed)
    table = (rng.randn(N, D) / np.sqrt(D)).astype(np.float32)
    target = (rng.randn(N, D) / np.sqrt(D)).astype(np.float32)
    return table, target


def _jax_run(step_fn, table, state, target, batches):
    step_fn = jax.jit(step_fn)
    tgt = jnp.asarray(target)
    t = jnp.asarray(table)
    for ids in batches:
        ids = jnp.asarray(ids)
        t, state = step_fn(t, state, ids, t[ids] - tgt[ids])
    return np.asarray(t), jax.device_get(state)


def _torch_run(step_fn, table, state, target, batches):
    tgt = torch.from_numpy(target)
    losses = []
    for ids in batches:
        ids = torch.from_numpy(ids)
        rows = table[ids.long()] - tgt[ids.long()]
        losses.append(float(torch.mean(rows * rows)))
        table, state = step_fn(table, state, ids, rows)
    return table, state, losses


@pytest.mark.parametrize("backend", ["xla", "tiled"])
@pytest.mark.parametrize("clean", [False, True])
def test_sparse_embedding_trajectory_matches_jax(backend, clean):
    batches = _batches(30)
    table, target = _start()
    jc = JClean(alpha=0.5, every=10) if clean else None
    tc = TClean(alpha=0.5, every=10) if clean else None
    _, j_step, j_opt = j_make(N, D, lr=5e-3, cleaning=jc,
                              hparams=JHP(backend="xla"))
    _, t_step, t_opt = t_make(N, D, lr=5e-3, cleaning=tc,
                              hparams=THP(backend=backend), device="cpu")
    j_state0 = jax.device_get(j_opt.init())
    t_table, t_state = convert.from_jax_state(table, j_state0, "cpu")
    assert set(t_state) == set(t_opt.init()) == {"step", "m", "v"}
    j_table, j_state = _jax_run(j_step, table, j_opt.init(), target, batches)
    t_table, t_state, losses = _torch_run(t_step, t_table, t_state, target,
                                          batches)
    out_table, out_state = convert.to_numpy(t_table, t_state)
    assert int(out_state["step"]) == int(j_state["step"]) == 30
    np.testing.assert_allclose(out_table, j_table, **TRAJ_TOL)
    for key in ("m", "v"):
        np.testing.assert_allclose(out_state[key], np.asarray(j_state[key]),
                                   **TRAJ_TOL)
    assert losses[-1] < losses[0]


def test_online_adapt_matches_jax():
    batches = _batches(10, seed=3)
    table, target = _start(seed=3)
    j_init, j_step = j_adapt(N, D, lr=1e-2, store_backend="xla")
    t_init, t_step = t_adapt(N, D, lr=1e-2, device="cpu")
    j_state0 = jax.device_get(j_init())
    assert j_state0["m"] is None and t_init()["m"] is None
    t_table, t_state = convert.from_jax_state(table, j_state0, "cpu")
    j_table, j_state = _jax_run(j_step, table, j_init(), target, batches)
    t_table, t_state, _ = _torch_run(t_step, t_table, t_state, target,
                                     batches)
    np.testing.assert_allclose(t_table.numpy(), j_table, **TRAJ_TOL)
    np.testing.assert_allclose(t_state["v"].numpy(), np.asarray(j_state["v"]),
                               **TRAJ_TOL)


def test_store_tree_drives_the_step():
    """A StoreTree at the table's path supersedes the hparams sizing, and
    a β₁=0 tree drops the first moment."""
    tree = StoreTree(rules=(("emb", None,
                             CountMinStore(compression=8.0,
                                           width_multiple=16)),))
    init_fn, step_fn, opt = t_make(N, D, path="emb", stores=tree,
                                   device="cpu")
    state = opt.init()
    assert state["m"] is None and state["v"].shape == (3, 48, D)
    table = init_fn(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_batches(1)[0])
    table, state = step_fn(table, state, ids, torch.ones(K, D))
    assert int(state["step"]) == 1 and torch.isfinite(table).all()
    with pytest.raises(ValueError, match="signed"):
        t_make(N, D, path="emb", device="cpu", stores=StoreTree(rules=(
            ("emb", CountMinStore(), CountMinStore()),)))
    assert CountSketchStore().kind == "sketch"


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="A13"):
        t_make(N, D, dp_axis="data", device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        t_make(N, D, sketch_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        t_adapt(N, D, dp_axis="data", device="cpu")
