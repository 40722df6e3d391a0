"""The port's small core functions against the JAX package.

``tree_bytes``/``state_bytes`` count the same bytes as the reference on
converted states (f32, bf16 and int8 sketches, ``None`` leaves, the
step).  ``linear_decay`` is held at rtol 1e-6.  ``adam_sparse_rows`` (the
in-graph path with and without ``strict_paper``, and through a backend)
and ``momentum_sparse_rows`` are held at rtol 1e-5, atol 1e-6, one call
(the tolerance of ``tests/test_torch_backends.py``).  The dense sketch
helpers involve no product and are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as JO
from repro.core import sketch as jcs
from repro.core import stores as jstores
from repro.core.cleaning import CleaningSchedule as JClean
from repro.core.partition import SketchPolicy as JPolicy
from repro_torch import convert
from repro_torch.core import optimizers as TO
from repro_torch.core import sketch as tcs
from repro_torch.core import stores as tstores
from repro_torch.core.cleaning import CleaningSchedule as TClean
from repro_torch.core.partition import SketchPolicy as TPolicy

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N, D, K = 600, 16, 40


def _params():
    rng = np.random.RandomState(0)
    return {"tok_embed": {"table": rng.randn(N, D).astype(np.float32)},
            "final_norm": {"scale": np.ones((D,), np.float32)}}


# ------------------------------------------------------------- bytes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("track", [True, False])
def test_state_bytes_match_reference(dtype, track):
    params = _params()
    hp = dict(compression=4.0, width_multiple=16, dtype=dtype)
    j_opt = JO.countsketch_adam(1e-3, policy=JPolicy(min_rows=100),
                                hparams=JO.SketchHParams(**hp),
                                track_first_moment=track)
    t_opt = TO.countsketch_adam(1e-3, policy=TPolicy(min_rows=100),
                                hparams=TO.SketchHParams(**hp),
                                track_first_moment=track)
    j_state = j_opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    want = JO.state_bytes(j_state)
    assert want == jstores.tree_bytes(j_state)
    converted = convert.tree_from_numpy(jax.device_get(j_state), "cpu")
    assert TO.state_bytes(converted) == want
    own = t_opt.init(convert.tree_from_numpy(params, "cpu"))
    assert TO.state_bytes(own) == tstores.tree_bytes(own) == want


def test_tree_bytes_counts_leaves():
    tree = {"step": torch.zeros((), dtype=torch.int32), "m": None,
            "v": [torch.zeros((2, 3)), np.zeros((4,), np.float16)],
            "n": 3, "q": tcs.init(tcs.SketchSpec(depth=2, width=512, dim=4,
                                                 dtype="int8"), "cpu")}
    assert tstores.tree_bytes(tree) == 4 + 24 + 8 + (2 * 512 * 4 + 2 * 2 * 4)
    assert tstores.tree_bytes(None) == 0


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("floor", [0.0, 1e-4])
def test_linear_decay_matches_reference(floor):
    j_sched = JO.linear_decay(3e-3, 70, floor=floor)
    t_sched = TO.linear_decay(3e-3, 70, floor=floor)
    for step in (0, 1, 13, 35, 69, 70, 500):
        want = float(j_sched(jnp.asarray(step, jnp.int32)))
        got = t_sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_linear_decay_drives_a_step():
    opt = TO.adam(TO.linear_decay(1e-2, 4))
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    moves = []
    for _ in range(5):
        before = params["w"].clone()
        u, state = opt.update({"w": torch.ones(3)}, state)
        TO.apply_updates(params, u)
        moves.append(float((params["w"] - before).abs().max()))
    assert moves[0] > moves[1] > moves[2] > 0.0 and moves[4] == 0.0


# ------------------------------------------------------------- sparse rows
def _specs(dtype="float32"):
    kw = dict(compression=4.0, width_multiple=16, dtype=dtype)
    return [(mod.for_param((N, D), signed=True, seed=1, **kw),
             mod.for_param((N, D), signed=False, seed=2, **kw))
            for mod in (jcs, tcs)]


def _sketch_inputs(spec_m, spec_v, seed, unique=True):
    rng = np.random.RandomState(seed)
    M = (rng.randn(*spec_m.shape) * 0.1).astype(np.float32)
    V = np.abs(rng.randn(*spec_v.shape) * 0.01).astype(np.float32)
    ids = (rng.choice(N, K, replace=False) if unique
           else rng.randint(0, 50, K)).astype(np.int32)
    g = rng.randn(K, D).astype(np.float32)
    return M, V, ids, g


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("clean", [False, True])
def test_adam_sparse_rows_in_graph_matches_reference(strict, track, clean):
    (jm, jv), (tm, tv) = _specs()
    M, V, ids, g = _sketch_inputs(jm, jv, seed=int(strict) + 2 * int(track))
    step = 10
    j_clean = JClean(alpha=0.5, every=10) if clean else None
    t_clean = TClean(alpha=0.5, every=10) if clean else None
    kw = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8, strict_paper=strict)
    want = JO.adam_sparse_rows(jm if track else None, jv,
                               jnp.asarray(M) if track else None,
                               jnp.asarray(V), jnp.asarray(ids),
                               jnp.asarray(g), jnp.asarray(step, jnp.int32),
                               cleaning=j_clean, **kw)
    got = TO.adam_sparse_rows(tm if track else None, tv,
                              torch.from_numpy(M.copy()) if track else None,
                              torch.from_numpy(V.copy()), torch.from_numpy(ids),
                              torch.from_numpy(g),
                              torch.tensor(step, dtype=torch.int32),
                              cleaning=t_clean, **kw)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("backend", ["ref", "xla", "tiled"])
def test_adam_sparse_rows_through_a_backend(backend):
    """Duplicate ids, a cleaning schedule firing at this step: the port's
    backend against the reference's (``tiled`` against its ``xla``, the
    semantics the port's ``tiled`` has)."""
    (jm, jv), (tm, tv) = _specs()
    M, V, ids, g = _sketch_inputs(jm, jv, seed=5, unique=False)
    kw = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8)
    want = JO.adam_sparse_rows(jm, jv, jnp.asarray(M), jnp.asarray(V),
                               jnp.asarray(ids), jnp.asarray(g),
                               jnp.asarray(10, jnp.int32),
                               cleaning=JClean(alpha=0.5, every=10),
                               backend="xla" if backend == "tiled"
                               else backend, **kw)
    got = TO.adam_sparse_rows(tm, tv, torch.from_numpy(M.copy()),
                              torch.from_numpy(V.copy()), torch.from_numpy(ids),
                              torch.from_numpy(g),
                              torch.tensor(10, dtype=torch.int32),
                              cleaning=TClean(alpha=0.5, every=10),
                              backend=backend, **kw)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_strict_paper_needs_the_in_graph_path():
    (_, _), (tm, tv) = _specs()
    z = torch.zeros
    with pytest.raises(ValueError, match="strict_paper"):
        TO.adam_sparse_rows(tm, tv, z(tm.shape), z(tv.shape),
                            torch.arange(4, dtype=torch.int32), z((4, D)),
                            torch.tensor(1), lr=1e-3, strict_paper=True,
                            backend="xla")
    with pytest.raises(ValueError, match="adam_sparse_rows"):
        TO.sparse_rows_adam(1e-3, shape=(N, D),
                            hparams=TO.SketchHParams(strict_paper=True),
                            device="cpu")


@pytest.mark.parametrize("strict", [False, True])
def test_momentum_sparse_rows_matches_reference(strict):
    (jm, _), (tm, _) = _specs()
    M, _, ids, g = _sketch_inputs(jm, jm, seed=9)
    want = JO.momentum_sparse_rows(jm, jnp.asarray(M), jnp.asarray(ids),
                                   jnp.asarray(g), jnp.asarray(4, jnp.int32),
                                   lr=2e-2, gamma=0.9, strict_paper=strict)
    got = TO.momentum_sparse_rows(tm, torch.from_numpy(M.copy()),
                                  torch.from_numpy(ids), torch.from_numpy(g),
                                  torch.tensor(4, dtype=torch.int32),
                                  lr=2e-2, gamma=0.9, strict_paper=strict)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# ------------------------------------------------------------- dense helpers
def _leaves(S):
    return [np.asarray(x) for x in (S if isinstance(S, tuple) else (S,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("signed", [True, False])
def test_dense_sketch_helpers_bit_equal(dtype, signed):
    rng = np.random.RandomState(int(signed))
    n = 300
    kw = dict(compression=4.0, width_multiple=16, dtype=dtype, signed=signed,
              seed=3)
    js, ts = jcs.for_param((n, D), **kw), tcs.for_param((n, D), **kw)
    delta = rng.randn(n, D).astype(np.float32)
    J = jcs.update_dense(js, jcs.init(js), jnp.asarray(delta))
    T = tcs.update_dense(ts, tcs.init(ts, "cpu"), torch.from_numpy(delta))
    J2, j_est = jcs.update_and_query_dense(js, J, jnp.asarray(delta * 0.5))
    T2, t_est = tcs.update_and_query_dense(ts, T,
                                           torch.from_numpy(delta * 0.5))
    for a, b in zip(_leaves(jax.device_get(J2)),
                    convert.tree_to_numpy(T2 if isinstance(T2, tuple)
                                          else (T2,))):
        np.testing.assert_array_equal(np.asarray(b), a)
    np.testing.assert_array_equal(t_est.numpy(), np.asarray(j_est))
    np.testing.assert_array_equal(
        tcs.query_dense(ts, T2, n).numpy(),
        np.asarray(jcs.query_dense(js, J2, n)))
