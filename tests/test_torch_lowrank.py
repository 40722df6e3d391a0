"""The port's LR-NMF-V (rank-1 2nd moment) against the JAX package's.

``nmf_rank1_adam``, the ℓ2 rank-1 helpers, ``Rank1Store`` and the
``scale_by_adam`` rank-1 branch (through ``countsketch_adam(
rank1_policy=...)`` and a planned CS-V floor) start from one numpy
state and are held at rtol 1e-5/atol 1e-6 after one call and rtol
1e-4/atol 1e-5 after a 10-step trajectory (ROADMAP's tolerances: torch's
and XLA's row and column means sum in other orders).  Torch runs on one
CPU thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.core import lowrank as JL
from repro.core import optimizers as JO
from repro.core import stores as JST
from repro_torch import convert
from repro_torch import plan as TP
from repro_torch.core import lowrank as TL
from repro_torch.core import optimizers as TO
from repro_torch.core import stores as TST

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)          # one call
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)     # after a trajectory
SHAPES = {"tok_embed": {"table": (2048, 24)}, "w": (16, 8), "b": (8,)}


def _params(rng):
    np_params = {"tok_embed": {"table": rng.randn(2048, 24).astype(np.float32)},
                 "w": rng.randn(16, 8).astype(np.float32),
                 "b": rng.randn(8).astype(np.float32)}
    return (jax.tree_util.tree_map(jnp.asarray, np_params),
            convert.tree_from_numpy(np_params, "cpu"))


def _grads(rng, steps):
    out = []
    for _ in range(steps):
        g = {"tok_embed": {"table": rng.randn(2048, 24).astype(np.float32)},
             "w": rng.randn(16, 8).astype(np.float32),
             "b": rng.randn(8).astype(np.float32)}
        g["tok_embed"]["table"][rng.rand(2048) < 0.7] = 0.0   # sparse rows
        out.append(g)
    return out


def _close(t_tree, j_tree, tol):
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(j_tree))
    flat_t = jax.tree_util.tree_leaves_with_path(
        convert.tree_to_numpy(t_tree))
    assert [jax.tree_util.keystr(p) for p, _ in flat_t] == \
        [jax.tree_util.keystr(p) for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _run(j_opt, t_opt, steps, seed=0):
    rng = np.random.RandomState(seed)
    j_p, t_p = _params(rng)
    j_st = j_opt.init(j_p)
    t_st = convert.tree_from_numpy(jax.device_get(j_st), "cpu")
    for i, g in enumerate(_grads(rng, steps)):
        j_u, j_st = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 j_st, j_p)
        t_u, t_st = t_opt.update(convert.tree_from_numpy(g, "cpu"), t_st,
                                 t_p)
        j_p = JO.apply_updates(j_p, j_u)
        TO.apply_updates(t_p, t_u)
        if i == 0:
            _close(t_u, j_u, TOL)
            _close(t_st, j_st, TOL)
    _close(t_p, j_p, TRAJ_TOL)
    _close(t_st, j_st, TRAJ_TOL)
    return t_st


def _rank1_policy(path, shape):
    return path == "tok_embed/table"


def test_nmf_rank1_adam_matches_reference():
    st = _run(JL.nmf_rank1_adam(1e-2, policy=_rank1_policy),
              TL.nmf_rank1_adam(1e-2, policy=_rank1_policy), 10)
    v = st["v"]["tok_embed"]["table"]
    assert isinstance(v, TST.Rank1Moment)
    assert tuple(v.r.shape) == (2048,) and tuple(v.c.shape) == (24,)
    assert int(st["step"]) == 10


def test_countsketch_adam_rank1_policy_matches_reference():
    """The LR-NMF-V leaves through ``scale_by_adam``'s rank-1 branch
    (dense m, ``Rank1Store`` v) beside dense and count-sketch leaves."""
    def policy(path, shape):
        return path in ("w", "tok_embed/table")

    st = _run(JO.countsketch_adam(1e-2, policy=policy,
                                  rank1_policy=_rank1_policy),
              TO.countsketch_adam(1e-2, policy=policy,
                                  rank1_policy=_rank1_policy), 10)
    assert isinstance(st["v"]["tok_embed"]["table"], TST.Rank1Moment)
    assert tuple(st["v"]["w"].shape) == (3, 256, 8)     # the sketched leaf


@pytest.mark.parametrize("backend", [None, "xla"])
def test_planned_cs_v_floor_matches_reference(backend):
    """``plan_for_params`` at its CS-V floor puts the wide table's v in a
    ``Rank1Store``; ``make_optimizer`` runs it as the reference does."""
    j_ps = {"tok_embed": {"table": jnp.zeros((2048, 512))},
            "w": jnp.zeros((16, 8))}
    t_ps = {"tok_embed": {"table": torch.zeros(2048, 512)},
            "w": torch.zeros(16, 8)}
    kw = dict(sketch_first_moment=False, width_multiple=16)
    jplan = JP.plan_for_params(j_ps, JP.min_budget_bytes(j_ps, **kw), **kw)
    tplan = TP.plan_for_params(t_ps, TP.min_budget_bytes(t_ps, **kw), **kw)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.leaf("tok_embed/table").mode == "rank1"
    j_opt = jplan.make_optimizer(1e-2, backend=backend)
    t_opt = tplan.make_optimizer(1e-2, backend=backend)
    rng = np.random.RandomState(3)
    j_st = j_opt.init(j_ps)
    t_st = convert.tree_from_numpy(jax.device_get(j_st), "cpu")
    assert TP.measure_aux_bytes(t_st) == tplan.predicted_aux_bytes
    j_p = {"tok_embed": {"table": jnp.asarray(
        rng.randn(2048, 512).astype(np.float32))}, "w": j_ps["w"]}
    t_p = convert.tree_from_numpy(jax.device_get(j_p), "cpu")
    for _ in range(10):
        g = {"tok_embed": {"table": rng.randn(2048, 512).astype(np.float32)},
             "w": rng.randn(16, 8).astype(np.float32)}
        j_u, j_st = j_opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 j_st)
        t_u, t_st = t_opt.update(convert.tree_from_numpy(g, "cpu"), t_st)
        j_p, t_p = JO.apply_updates(j_p, j_u), TO.apply_updates(t_p, t_u)
    _close(t_p, j_p, TRAJ_TOL)
    _close(t_st, j_st, TRAJ_TOL)


def test_rank1_store_matches_reference():
    rng = np.random.RandomState(1)
    j = JST.Rank1Store().bind("t", (300, 12), jnp.float32)
    t = TST.Rank1Store().bind("t", (300, 12))
    assert t.shape == j.shape and t.bytes() == j.bytes() == (300 + 12) * 4
    j_s = j.init()
    t_s = t.init("cpu")
    assert t.bytes(t_s) == j.bytes(j_s)
    rows = rng.randint(0, 300, 40).astype(np.int32)
    for _ in range(3):
        d = np.abs(rng.randn(300, 12)).astype(np.float32)
        j_s = j.decay(j_s, 0.9)
        j_s = j.accumulate(j_s, jnp.asarray(d), scale=0.1)
        t_s = t.decay(t_s, 0.9)
        t_s = t.accumulate(t_s, torch.from_numpy(d), scale=0.1)
        for r in (None, rows):
            np.testing.assert_allclose(
                t.read(t_s, None if r is None else torch.from_numpy(r)
                       ).numpy(),
                np.asarray(j.read(j_s, None if r is None else
                                  jnp.asarray(r))), **TOL)
    j_s, j_est = j.update_read(j_s, jnp.asarray(d), 0.999, scale=0.001)
    t_s, t_est = t.update_read(t_s, torch.from_numpy(d), 0.999, scale=0.001)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(j_est), **TOL)
    with pytest.raises(ValueError, match="full"):
        t.accumulate(t_s, torch.zeros(4, 12), torch.arange(4))
    with pytest.raises(ValueError, match="rank-2"):
        TST.Rank1Store().bind("v", (5,))


def test_l2_rank1_matches_reference():
    rng = np.random.RandomState(2)
    target = rng.randn(64, 24).astype(np.float32)
    j = JL.l2_rank1_init((64, 24))
    t = TL.l2_rank1_init((64, 24), device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for _ in range(3):
        j = JL.l2_rank1_step(j, jnp.asarray(target))
        t = TL.l2_rank1_step(t, torch.from_numpy(target))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(TL.l2_rank1_reconstruct(t).numpy(),
                               np.asarray(JL.l2_rank1_reconstruct(j)),
                               **TOL)
    r, c = np.abs(rng.randn(64)), np.abs(rng.randn(24))
    np.testing.assert_allclose(
        TL.nmf_rank1_reconstruct(torch.from_numpy(r).float(),
                                 torch.from_numpy(c).float()).numpy(),
        np.asarray(JL.nmf_rank1_reconstruct(jnp.asarray(r, jnp.float32),
                                            jnp.asarray(c, jnp.float32))),
        **TOL)


def test_rank1_moment_converts_both_ways():
    """A reference ``Rank1Moment`` becomes the port's and comes back as
    one, bit for bit."""
    j = JST.Rank1Moment(jnp.arange(5, dtype=jnp.float32),
                        jnp.ones(3, jnp.float32))
    t = convert.tree_from_numpy({"v": jax.device_get(j)}, "cpu")["v"]
    assert isinstance(t, TST.Rank1Moment)
    back = convert.tree_to_numpy(t)
    assert isinstance(back, TST.Rank1Moment)
    for a, b in zip(back, j):
        np.testing.assert_array_equal(a, np.asarray(b))
