"""The port's data-parallel sketched reduce against the JAX package.

``repro_torch.distributed`` runs R replicas of a step body in R threads
of one process (``ReplicaGroup``), the counterpart of the reference's
``vmap(axis_name=...)`` model of a mesh axis (``tests/test_distributed.py``).
Three things are held here, with n 512, d 16, R 4 and k 32 a replica:

* the collectives and the byte model, and ``reduce_moments``,
  ``global_unique_ids`` and ``dp_adam_rows`` against the reference's
  under ``jax.vmap`` on the same numpy inputs: integers (ids, masks) to
  the bit, floats within rtol 1e-5/atol 1e-6 for one step and rtol
  1e-4/atol 1e-5 after 10 steps; the reference's four error-feedback
  cases and its traffic-ratio cases, ported;
* the reference's dyadic protocol (``tests/test_distributed_dp.py``):
  with β₁ = β₂ = 0.5 and integer rows in [-3, 3] every sum is exact, so
  the DP first moment equals the single-device step's on the
  concatenated batch to the bit, the DP second moment stays within the
  modelled cross-term bound, and identity sketches with aligned rows make
  the error feedback exact;
* the four ``dp_axis`` steps (sparse embedding, serve fleet, extreme,
  LM) against the reference's ``shard_map`` steps, run once for the
  module in a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` that writes
  every result to one ``.npz`` (``_jax_reference``).  Every replica must
  end each step with the same table and state bits.

A numpy buffer handed to JAX is never one the port writes: the port gets
copies (``torch.tensor``), since it writes tables and sketches in place.
Torch runs on one CPU thread, as in ``test_torch_dense.py``.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sketch as jcs
from repro.core.optimizers import SketchHParams as JHP
from repro.distributed import sketched_reduce as jsr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import optimizers as TO
from repro_torch.core import sketch as tcs
from repro_torch.core.optimizers import SketchHParams as THP
from repro_torch.core.partition import leaf_paths
from repro_torch.data import pipeline as tp
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sketched_reduce as tsr
from repro_torch.serve.steps import make_online_adapt_step as t_adapt
from repro_torch.train import extreme as tx
from repro_torch.train import steps as TS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, D, R, K = 512, 16, 4, 32
LR, STEPS = 1e-2, 10
TOL = dict(rtol=1e-5, atol=1e-6)          # one step
TRAJ = dict(rtol=1e-4, atol=1e-5)         # after a trajectory
GROUP_TIMEOUT = 120.0                     # s a replica waits at a barrier
REFERENCE_TIMEOUT = 900                   # s for the JAX subprocess
X_KW = dict(n_classes=50_000, n_meta=4096, n_features=2048, dim=16, nnz=8,
            n_negatives=64)
X_BATCH = 32                              # global; 8 a replica
LM_BATCH, LM_SEQ, LM_STEPS = 8, 32, 3     # global; 2 sequences a replica


def _group(size=R):
    return col.ReplicaGroup(size, timeout=GROUP_TIMEOUT)


def _run(group, fn, shards):
    """``fn(group, *shard)`` in each replica."""
    return group.run(lambda *a: fn(group, *a), shards)


def _vmap(fn, *sharded):
    return jax.vmap(fn, axis_name="data")(*sharded)


def _t(a):
    """A torch copy of a numpy array (the port writes in place)."""
    return torch.tensor(np.asarray(a))


def _specs(compression=2.0, identity=False, seeds=(7, 8), wm=64):
    """(jax m, jax v, port m, port v) specs of one (N, D) table."""
    kw = dict(compression=compression, identity=identity, width_multiple=wm)
    jm = jcs.for_param((N, D), seed=seeds[0], **kw)
    jv = jcs.for_param((N, D), seed=seeds[1], signed=False, **kw)
    tm = tcs.for_param((N, D), seed=seeds[0], **kw)
    tv = tcs.for_param((N, D), seed=seeds[1], signed=False, **kw)
    assert (tm.depth, tm.width, tv.width) == (jm.depth, jm.width, jv.width)
    return jm, jv, tm, tv


def _shards(seed, r=R, k=K, hi=N // 2, dyadic=False):
    """(ids (r, k) int32, rows (r, k, D) f32); ids below ``hi`` so that
    replicas share ids and batches hold duplicates."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, hi, (r, k)).astype(np.int32)
    if dyadic:
        rows = rng.randint(-3, 4, (r, k, D)).astype(np.float32)
    else:
        rows = rng.randn(r, k, D).astype(np.float32)
    return ids, rows


# ------------------------------------------------------------ collectives
def test_replica_psum_adds_in_rank_order_into_own_copies():
    parts = [torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32) * (r + 1)
             + r for r in range(R)]
    before = [p.clone() for p in parts]
    want = parts[0].clone()
    for p in parts[1:]:
        want += p

    def body(g, x):
        s = g.psum(x)
        s.mul_(g.rank + 2)           # in place: must not reach the others
        return s, g.rank

    outs = _run(_group(), body, [(p,) for p in parts])
    for rank, (s, got_rank) in enumerate(outs):
        assert got_rank == rank
        assert torch.equal(s, want * (rank + 2))
    assert all(torch.equal(p, q) for p, q in zip(parts, before))


def test_replica_all_gather_and_pmean():
    def body(g, x):
        return g.all_gather(x), g.pmean(x.to(torch.float32))

    xs = [torch.arange(3, dtype=torch.int32) + 10 * r for r in range(3)]
    outs = _run(_group(3), body, [(x,) for x in xs])
    for gathered, mean in outs:
        assert torch.equal(gathered, torch.stack(xs))
        assert torch.equal(mean, (xs[0] + xs[1] + xs[2]).float() / 3.0)
    assert outs[0][0].data_ptr() != outs[1][0].data_ptr()


@pytest.mark.parametrize("where", ["before", "after"])
def test_failing_replica_breaks_the_group(where):
    g = _group(3)

    def body(grp, r):
        if where == "after":
            grp.psum(torch.ones(2))
        if r == 1:
            raise KeyError("replica 1")
        return grp.psum(torch.ones(2))

    with pytest.raises(KeyError, match="replica 1"):
        g.run(lambda r: body(g, r), [(r,) for r in range(3)])
    # the group is whole again afterwards
    outs = g.run(lambda: g.psum(torch.ones(2)), [()] * 3)
    assert all(torch.equal(o, torch.full((2,), 3.0)) for o in outs)


def test_mismatched_collectives_time_out():
    g = col.ReplicaGroup(2, timeout=0.5)

    def body(r):
        return g.psum(torch.ones(1)) if r == 0 else None

    with pytest.raises(threading.BrokenBarrierError):
        g.run(body, [(0,), (1,)])


def test_replica_group_under_thread_stress():
    """More threads than cores and a tiny switch interval: a lost or torn
    slot would change some round's sum."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        size, rounds = 16, 30
        g = col.ReplicaGroup(size, timeout=GROUP_TIMEOUT)

        def body(rank):
            sums = []
            for i in range(rounds):
                sums.append(float(g.psum(torch.tensor(float(rank * i)))))
                ids = g.all_gather(torch.tensor([rank, i]))
                assert ids[:, 0].tolist() == list(range(size))
            return sums

        outs = g.run(body, [(r,) for r in range(size)])
    finally:
        sys.setswitchinterval(old)
    want = [float(sum(r * i for r in range(size))) for i in range(rounds)]
    assert all(o == want for o in outs)


def test_axis_arguments():
    assert col.as_axis(None) is None
    assert isinstance(col.as_axis("data"), col.ProcessGroupAxis)
    g = _group(2)
    assert col.as_axis(g) is g
    with pytest.raises(TypeError, match="psum"):
        col.as_axis(object())
    with pytest.raises(RuntimeError, match="ReplicaGroup.run"):
        g.rank
    with pytest.raises(ValueError, match="argument tuples"):
        g.run(lambda: None, [()])
    with pytest.raises(ValueError, match="size >= 1"):
        col.ReplicaGroup(0)


# ------------------------------------------------------------ byte model
def test_byte_model_matches_explicit_sizes():
    spec = tcs.SketchSpec(depth=3, width=1024, dim=64)
    n = 50_000
    dense = n * 64 * 4 + n * 4
    assert tsr.dense_reduce_bytes(n, 64) == dense
    assert tsr.sketched_reduce_bytes(spec) == 3 * 1024 * 64 * 4
    assert tsr.traffic_ratio(spec, n) == pytest.approx(dense / (3 * 1024
                                                                * 64 * 4))


def test_byte_model_dtype_aware():
    f32 = tcs.SketchSpec(depth=3, width=1024, dim=64)
    bf16 = tcs.SketchSpec(depth=3, width=1024, dim=64, dtype="bfloat16")
    assert tsr.traffic_ratio(bf16, 50_000) == pytest.approx(
        2.0 * tsr.traffic_ratio(f32, 50_000))
    assert tsr.traffic_ratio(f32, 50_000, grad_dtype=torch.bfloat16,
                             with_ids=False) == pytest.approx(
        0.5 * tsr.traffic_ratio(f32, 50_000, with_ids=False))


def test_extra_specs_share_the_collective():
    m = tcs.SketchSpec(depth=3, width=1024, dim=64)
    v = tcs.SketchSpec(depth=3, width=512, dim=64, signed=False)
    lone = tsr.traffic_ratio(m, 50_000)
    both = tsr.traffic_ratio(m, 50_000, extra_specs=(v,))
    assert both < lone
    assert both == pytest.approx(tsr.dense_reduce_bytes(50_000, 64)
                                 / (m.nbytes() + v.nbytes()))


def test_paper_compressions_exceed_5x():
    for compression in (5.0, 10.0, 20.0):
        spec_m = tcs.for_param((500_000, 64), compression=compression)
        spec_v = tcs.for_param((500_000, 64), compression=compression,
                               signed=False)
        ratio = tsr.traffic_ratio(spec_m, 500_000, extra_specs=(spec_v,))
        assert ratio >= 5.0 * (compression / 10.0)


@pytest.mark.parametrize("n_rows,dtype", [(4_096, "float32"),
                                          (151_936, "float32"),
                                          (1_000, "bfloat16")])
def test_byte_model_equals_reference(n_rows, dtype):
    jm = jcs.for_param((151_936, 896), dtype=dtype)
    jv = jcs.for_param((151_936, 896), signed=False, dtype=dtype)
    tm = tcs.for_param((151_936, 896), dtype=dtype)
    tv = tcs.for_param((151_936, 896), signed=False, dtype=dtype)
    assert tsr.sketched_reduce_bytes(tm, tv, None) \
        == jsr.sketched_reduce_bytes(jm, jv, None)
    assert tsr.dense_reduce_bytes(n_rows, 896) \
        == jsr.dense_reduce_bytes(n_rows, 896)
    assert tsr.traffic_ratio(tm, n_rows, extra_specs=(tv,)) \
        == jsr.traffic_ratio(jm, n_rows, extra_specs=(jv,))


def test_byte_model_at_the_card_shapes():
    """qwen2-0.5b's table under ``SketchHParams()``: at a replica's 4,096
    rows the sketches are the larger payload; they win past ~61,000."""
    hp = THP()
    m = hp.spec("t", (151_936, 896), signed=True)
    v = hp.spec("t", (151_936, 896), signed=False)
    assert m.shape == (3, 10_240, 896)
    assert tsr.sketched_reduce_bytes(m, v) == 220_200_960
    assert tsr.sketched_reduce_bytes(m, v, v) == 330_301_440
    assert tsr.dense_reduce_bytes(4_096, 896) == 14_696_448
    assert tsr.traffic_ratio(m, 4_096, extra_specs=(v,)) \
        == pytest.approx(0.06674, abs=1e-5)
    assert tsr.traffic_ratio(m, 151_936, extra_specs=(v,)) \
        == pytest.approx(2.48, abs=0.01)
    cross = 220_200_960 / (896 * 4 + 4)
    assert 61_000 < cross < 61_500


# ------------------------------------------------------------ the reductions
def _identity_specs():
    kw = dict(compression=1.0, identity=True, width_multiple=8)
    n, d = 32, 4
    return (jcs.for_param((n, d), **kw),
            jcs.for_param((n, d), signed=False, **kw),
            tcs.for_param((n, d), **kw),
            tcs.for_param((n, d), signed=False, **kw))


def _both_reduce(specs, ids, rows, feedback):
    """``reduce_moments`` in both packages: (jax outs, port outs by
    replica)."""
    jm, jv, tm, tv = specs
    res0 = jsr.init_feedback(jv) if feedback else None
    jout = _vmap(lambda i, r: jsr.reduce_moments(jm, jv, i, r, "data",
                                                 residual=res0),
                 jnp.asarray(ids), jnp.asarray(rows))

    def body(g, i, r):
        res = tsr.init_feedback(tv, "cpu") if feedback else None
        return tsr.reduce_moments(tm, tv, i, r, g, residual=res)

    tout = _run(_group(ids.shape[0]), body,
                [(_t(ids[r]), _t(rows[r])) for r in range(ids.shape[0])])
    return jout, tout


def _hold_reduce(jout, tout):
    for r, out in enumerate(tout):
        for slot, (want, got) in enumerate(zip(jout, out)):
            assert (want is None) == (got is None)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want[r]),
                                           err_msg=f"slot {slot}", **TOL)
                assert torch.equal(got, tout[0][slot])


def test_identity_sketch_feedback_is_exact():
    specs = _identity_specs()
    k, d = 8, 4
    rng = np.random.RandomState(0)
    ids = np.broadcast_to(np.arange(k, dtype=np.int32), (R, k)).copy()
    rows = np.abs(rng.randn(R, k, d)).astype(np.float32)
    jout, tout = _both_reduce(specs, ids, rows, True)
    _hold_reduce(jout, tout)
    tm, tv = specs[2:]
    G_m, G_v, res = tout[0]
    probe = torch.arange(k, dtype=torch.int32)
    truth = np.square(rows.sum(0))
    np.testing.assert_allclose(tcs.query(tv, G_v, probe).numpy(), truth,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.numpy(), 0.0, atol=1e-4)
    want_m = tsr.local_sketch(tm, probe, _t(rows.sum(0)))
    np.testing.assert_allclose(G_m.numpy(), want_m.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_clipped_feedback_never_undershoots_truth():
    specs = _identity_specs()
    k, d = 8, 4
    rng = np.random.RandomState(2)
    ids = np.broadcast_to(np.arange(k, dtype=np.int32), (R, k)).copy()
    rows = rng.randn(R, k, d).astype(np.float32)
    jout, tout = _both_reduce(specs, ids, rows, True)
    _hold_reduce(jout, tout)
    got = tcs.query(specs[3], tout[0][1], torch.arange(k)).numpy()
    truth = np.square(rows.sum(0))
    assert (got >= truth - 1e-4).all()
    assert (got >= -1e-6).all()


def test_no_feedback_underestimates_by_cross_term():
    specs = _identity_specs()
    k, d = 8, 4
    rng = np.random.RandomState(1)
    ids = np.broadcast_to(np.arange(k, dtype=np.int32), (R, k)).copy()
    rows = rng.randn(R, k, d).astype(np.float32)
    jout, tout = _both_reduce(specs, ids, rows, False)
    _hold_reduce(jout, tout)
    assert tout[0][2] is None
    got = tcs.query(specs[3], tout[0][1], torch.arange(k)).numpy()
    sum_sq = np.square(rows).sum(0)
    truth = np.square(rows.sum(0))
    np.testing.assert_allclose(got, sum_sq, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(truth - got, truth - sum_sq, rtol=1e-4,
                               atol=1e-5)


def test_feedback_reduces_error_with_real_sketches():
    specs = _specs(seeds=(7, 8))
    tv = specs[3]
    n, k = 512, 48
    errs = {True: [], False: []}
    for trial in range(4):
        rng = np.random.RandomState(100 + trial)
        probe = rng.choice(n, size=k, replace=False).astype(np.int32)
        ids = np.broadcast_to(probe, (R, k)).copy()
        common = rng.randn(1, k, D)
        rows = (rng.randn(R, k, D) * 0.3 + common).astype(np.float32)
        truth = np.square(rows.sum(0))
        for fb in (True, False):
            jout, tout = _both_reduce(specs, ids, rows, fb)
            _hold_reduce(jout, tout)
            est = tcs.query(tv, tout[0][1], _t(probe)).numpy()
            errs[fb].append(float(np.mean(np.abs(est - truth))))
    assert np.mean(errs[True]) < np.mean(errs[False])


@pytest.mark.parametrize("feedback", [False, True])
def test_reduce_moments_matches_reference(feedback):
    ids, rows = _shards(3)
    jout, tout = _both_reduce(_specs(), ids, rows, feedback)
    _hold_reduce(jout, tout)


@pytest.mark.parametrize("seed,r,k", [(0, 4, 32), (1, 2, 32), (2, 3, 7)])
def test_global_unique_ids_matches_reference(seed, r, k):
    rng = np.random.RandomState(seed)
    fill = tsr.FILL_ID
    local = []
    for _ in range(r):
        u = np.unique(rng.randint(0, 40, k).astype(np.int32))
        local.append(np.concatenate([u, np.full(k - u.size, fill,
                                                np.int32)]))
    local = np.stack(local)
    juids, jmask = _vmap(lambda i: jsr.global_unique_ids(
        i, "data", fill_id=fill), jnp.asarray(local))
    outs = _run(_group(r), lambda g, i: tsr.global_unique_ids(
        i, g, fill_id=fill), [(_t(x),) for x in local])
    want = np.unique(local[local != fill])
    for rank, (uids, mask) in enumerate(outs):
        assert uids.dtype == torch.int32
        np.testing.assert_array_equal(uids.numpy(), np.asarray(juids[rank]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask[rank]))
        np.testing.assert_array_equal(uids.numpy()[:want.size], want)
        assert int(mask.sum()) == want.size


def _both_dp_adam(specs, track_m, feedback, steps, dir_clip=10.0, seed=0):
    """``dp_adam_rows`` in both packages from one random state over
    ``steps`` steps: (jax final, port finals by replica)."""
    jm, jv, tm, tv = specs
    rng = np.random.RandomState(seed + 50)
    M0 = (rng.randn(*tm.shape) * 0.1).astype(np.float32) if track_m else None
    V0 = (np.abs(rng.randn(*tv.shape)) * 0.1).astype(np.float32)
    batches = [_shards(seed + s) for s in range(steps)]

    j_state = (None if M0 is None else jnp.asarray(M0), jnp.asarray(V0),
               jsr.init_feedback(jv) if feedback else None)
    for step, (ids, rows) in enumerate(batches, start=1):
        def f(i, r, st=j_state, step=step):
            return jsr.dp_adam_rows(
                jm if track_m else None, jv, st[0], st[1], i, r,
                jnp.asarray(step), axis_name="data", residual=st[2],
                dir_clip=dir_clip)
        jout = _vmap(f, jnp.asarray(ids), jnp.asarray(rows))
        j_state = tuple(None if x is None else x[0]
                        for x in (jout.M, jout.V, jout.residual))

    def body(g):
        M = None if M0 is None else _t(M0)
        V, res = _t(V0), (tsr.init_feedback(tv, "cpu") if feedback
                          else None)
        for step, (ids, rows) in enumerate(batches, start=1):
            out = tsr.dp_adam_rows(
                tm if track_m else None, tv, M, V, _t(ids[g.rank]),
                _t(rows[g.rank]), step, axis_name=g, residual=res,
                dir_clip=dir_clip)
            M, V, res = out.M, out.V, out.residual
        return out

    return jout, _run(_group(), lambda g: body(g), [()] * R)


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("track_m", [True, False])
def test_dp_adam_rows_matches_reference(track_m, feedback):
    jout, touts = _both_dp_adam(_specs(), track_m, feedback, 1)
    for r, out in enumerate(touts):
        np.testing.assert_array_equal(out.uids.numpy(),
                                      np.asarray(jout.uids[r]))
        np.testing.assert_array_equal(out.mask.numpy(),
                                      np.asarray(jout.mask[r]))
        for name in ("M", "V", "residual", "rows"):
            want, got = getattr(jout, name), getattr(out, name)
            assert (want is None) == (got is None), name
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want[r]),
                                           err_msg=name, **TOL)
                assert torch.equal(got, getattr(touts[0], name)), name


@pytest.mark.parametrize("track_m,dir_clip", [(True, 10.0), (False, None)])
def test_dp_adam_rows_trajectory_matches_reference(track_m, dir_clip):
    jout, touts = _both_dp_adam(_specs(), track_m, True, STEPS,
                                dir_clip=dir_clip, seed=11)
    for name in ("M", "V", "residual", "rows"):
        want, got = getattr(jout, name), getattr(touts[0], name)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                                       err_msg=name, **TRAJ)


def test_dir_clip_clamps_the_direction():
    _, clipped = _both_dp_adam(_specs(compression=8.0), True, False, 1,
                               dir_clip=0.5)
    _, free = _both_dp_adam(_specs(compression=8.0), True, False, 1,
                            dir_clip=None)
    assert float(free[0].rows.abs().max()) > 0.5
    assert torch.equal(clipped[0].rows, free[0].rows.clamp(-0.5, 0.5))


def test_apply_unique_updates_drops_the_padding():
    """Global ids then out-of-range padding, as ``table.at[].add`` in drop
    mode: every live row gets one add, no other row changes, no sync."""
    rng = np.random.RandomState(4)
    table = rng.randn(N, D).astype(np.float32)
    uids = np.full(3 * K, tsr.FILL_ID, np.int32)
    live = np.unique(rng.randint(0, N, 2 * K)).astype(np.int32)
    uids[:live.size] = live
    rows = rng.randn(3 * K, D).astype(np.float32)
    rows[live.size:] = 0.0
    want = jnp.asarray(table).at[jnp.asarray(uids)].add(jnp.asarray(rows),
                                                         mode="drop")
    got = TO.apply_unique_updates(_t(table), {"ids": _t(uids),
                                              "rows": _t(rows)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ dyadic protocol
def _dyadic_steps(track_m, feedback, identity=False):
    hp = THP(compression=2.0, width_multiple=64, identity=identity)
    kw = dict(lr=1e-2, b1=0.5, b2=0.5, hparams=hp,
              track_first_moment=track_m, device="cpu")
    g = _group()
    init_fn, dp_step, dp_opt = TS.make_sparse_embedding_step(
        N, D, dp_axis=g, error_feedback=feedback, **kw)
    _, ref_step, ref_opt = TS.make_sparse_embedding_step(N, D, **kw)
    table = init_fn(torch.Generator().manual_seed(0))
    return g, table, (dp_step, dp_opt), (ref_step, ref_opt)


def _dp_round(g, step_fn, tables, states, ids, rows):
    """One DP step: each replica its shard, its own table and state."""
    outs = g.run(step_fn, [(tables[r], states[r], _t(ids[r]), _t(rows[r]))
                           for r in range(g.size)])
    return [o[0] for o in outs], [o[1] for o in outs]


def _replicas_equal(tables, states):
    for t, s in zip(tables[1:], states[1:]):
        assert torch.equal(t, tables[0])
        for k in ("m", "v", "residual"):
            assert (s[k] is None) == (states[0][k] is None)
            if s[k] is not None:
                assert torch.equal(s[k], states[0][k]), k


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("track_m", [True, False])
def test_first_moment_bit_identical(track_m, feedback):
    g, table, (dp_step, dp_opt), (ref_step, ref_opt) = _dyadic_steps(
        track_m, feedback)
    tables = [table.clone() for _ in range(R)]
    states = [dp_opt.init() for _ in range(R)]
    t_ref, s_ref = table.clone(), ref_opt.init()
    for seed in range(3):
        ids, rows = _shards(seed, dyadic=True)
        tables, states = _dp_round(g, dp_step, tables, states, ids, rows)
        t_ref, s_ref = ref_step(t_ref, s_ref, _t(ids.reshape(-1)),
                                _t(rows.reshape(-1, D)))
        _replicas_equal(tables, states)
        if track_m:
            assert torch.equal(states[0]["m"], s_ref["m"]), \
                f"M diverged at step {seed + 1}"
        else:
            assert states[0]["m"] is None
        assert int(states[0]["step"]) == int(s_ref["step"]) == seed + 1


def test_second_moment_within_modeled_bias():
    g, table, (dp_step, dp_opt), (ref_step, ref_opt) = _dyadic_steps(
        True, False)
    ids, rows = _shards(0, dyadic=True)
    tables, states = _dp_round(g, dp_step, [table.clone() for _ in range(R)],
                               [dp_opt.init() for _ in range(R)], ids, rows)
    _, s_ref = ref_step(table.clone(), ref_opt.init(),
                        _t(ids.reshape(-1)), _t(rows.reshape(-1, D)))
    spec_v = THP(compression=2.0, width_multiple=64).spec(
        "sparse_embedding", (N, D), signed=False)
    g_sum, g_sq = np.zeros((N, D)), np.zeros((N, D))
    for r in range(R):
        gr = np.zeros((N, D))
        np.add.at(gr, ids[r], rows[r])
        g_sum += gr
        g_sq += gr * gr
    cross = g_sum * g_sum - g_sq
    touched = np.where(np.abs(cross).sum(1) > 0)[0].astype(np.int32)
    bound = tsr.local_sketch(spec_v, _t(touched),
                             _t(np.abs(cross[touched]).astype(np.float32)))
    bound = 0.5 * bound.numpy() + 1e-4
    diff = np.abs(states[0]["v"].numpy() - s_ref["v"].numpy())
    assert (diff <= bound).all(), \
        f"V bias {diff.max()} exceeds the modelled bound {bound.max()}"
    assert diff.max() > 0.0            # the bias is there to bound


def test_error_feedback_exact_with_identity_sketches():
    g, table, (dp_step, dp_opt), (ref_step, ref_opt) = _dyadic_steps(
        True, True, identity=True)
    ids, rows = _shards(0, dyadic=True)
    rows = np.abs(rows)
    tables, states = _dp_round(g, dp_step, [table.clone() for _ in range(R)],
                               [dp_opt.init() for _ in range(R)], ids, rows)
    _, s_ref = ref_step(table.clone(), ref_opt.init(),
                        _t(ids.reshape(-1)), _t(rows.reshape(-1, D)))
    np.testing.assert_allclose(states[0]["v"].numpy(), s_ref["v"].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(states[0]["residual"].numpy(), 0.0,
                               atol=1e-5)


def test_online_adapt_dp_matches_single_device_update_rule():
    hp = THP(compression=1.0, width_multiple=64, identity=True)
    g = _group()
    init_dp, adapt_dp = t_adapt(N, D, lr=1e-2, b2=0.5, hparams=hp,
                                dp_axis=g, error_feedback=True,
                                device="cpu")
    init_1, adapt_1 = t_adapt(N, D, lr=1e-2, b2=0.5, hparams=hp,
                              device="cpu")
    table = np.random.RandomState(3).randn(N, D).astype(np.float32)
    ids, rows = _shards(3, dyadic=True)
    rows = np.abs(rows)
    tables, states = [_t(table) for _ in range(R)], [init_dp()
                                                     for _ in range(R)]
    t1, s1 = _t(table), init_1()
    for _ in range(2):
        tables, states = _dp_round(g, adapt_dp, tables, states, ids, rows)
        t1, s1 = adapt_1(t1, s1, _t(ids.reshape(-1)),
                         _t(rows.reshape(-1, D)))
    _replicas_equal(tables, states)
    np.testing.assert_allclose(states[0]["v"].numpy(), s1["v"].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tables[0].numpy(), t1.numpy(), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------------ errors
def test_dp_arguments_rejected_as_in_the_reference():
    with pytest.raises(ValueError, match="dense_adam"):
        tx.make_extreme_step(tx.MachConfig(**X_KW), optimizer="dense_adam",
                             dp_axis=_group(), device="cpu")
    with pytest.raises(ValueError, match="error_feedback"):
        t_adapt(N, D, error_feedback=True, device="cpu")
    with pytest.raises(ValueError, match="dir_clip"):
        t_adapt(N, D, dir_clip=None, device="cpu")
    # the sharded dp step is ported (tests/test_torch_sharded.py): it
    # refuses a shard axis of another size than sketch_shards, as the
    # reference's refuses such a mesh
    from repro.distributed import sharding as shd
    from repro.train.steps import make_sparse_embedding_step as j_make
    ids, rows = (a[0] for a in _shards(0))
    _, t_step, t_opt = TS.make_sparse_embedding_step(
        N, D, sketch_shards=2, dp_axis=_group(), shard_axis=_group(),
        device="cpu")
    with pytest.raises(ValueError, match="exactly that size"):
        t_step(_t(_table0()), t_opt.init(), _t(ids), _t(rows))
    _, j_step, j_opt = j_make(N, D, sketch_shards=2, dp_axis="data",
                              mesh=shd.make_mesh_compat((1, 1),
                                                        ("data", "model")))
    with pytest.raises(ValueError, match="exactly that size"):
        j_step(jnp.asarray(_table0()), j_opt.init(), jnp.asarray(ids),
               jnp.asarray(rows))
    # a mesh= is a collectives mesh naming the dp axis, as the
    # reference's shard_map names its mesh axis
    with pytest.raises(ValueError, match="axis named by dp_axis"):
        tx.make_extreme_step(tx.MachConfig(**X_KW), mesh=object(),
                             dp_axis=_group(), device="cpu")
    _, _, opts = tx.make_extreme_step(tx.MachConfig(**X_KW),
                                      mesh=col.ReplicaMesh((2, 1)),
                                      dp_axis="data", device="cpu")
    assert all("residual" in o.init() for o in opts.values())
    _, _, opt = TS.make_sparse_embedding_step(N, D, dp_axis="data",
                                              device="cpu")
    assert set(opt.init()) == {"step", "m", "v", "residual"}


# ------------------------------------------------------------ the JAX steps
def _table0(seed=0, n=N, d=D):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) / np.sqrt(d)).astype(np.float32)


def _sparse_batches(seed):
    return [_shards(seed * 100 + s) for s in range(STEPS)]


SPARSE_CASES = [(True, False), (True, True), (False, True), (False, False)]
SPARSE_HP = dict(compression=2.0, width_multiple=64)


def _extreme_batches():
    cfg = tx.MachConfig(**X_KW)
    stream = tx.MetaStream(tp.ExtremeStream(cfg.data_config(X_BATCH)),
                           cfg.class_maps()[0], device="cpu")
    return [{k: v.numpy() for k, v in stream.batch(i).items()}
            for i in range(STEPS)]


def _extreme_params(seed=5):
    cfg = tx.MachConfig(**X_KW)
    return {"tok_embed": {"table": _table0(seed, cfg.n_features, cfg.dim)},
            "class_head": {"table": _table0(seed + 1, cfg.n_meta,
                                            cfg.dim)}}


X_CASES = [("cs_rmsprop", False), ("cs_adam", True)]


def _lm_config(pkg):
    return pkg.get("qwen2_0_5b").reduced(vocab_size=2048)


def _lm_batches():
    rs = np.random.RandomState(7)
    out = []
    for _ in range(LM_STEPS):
        tok = rs.randint(1, 2048, (LM_BATCH, LM_SEQ)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out


def _put_tree(out, prefix, tree):
    for path, leaf in leaf_paths(jax.device_get(tree)):
        out[f"{prefix}/{path}"] = np.asarray(leaf)


def _jax_reference(path):
    """Every JAX ``dp_axis`` step result this module compares against, into
    one ``.npz``.  Runs in a subprocess under 4 forced host devices (the
    device count locks when JAX starts)."""
    from repro.distributed import sharding as shd
    from repro.serve.steps import make_online_adapt_step as j_adapt
    from repro.train import extreme as jx
    from repro.train import steps as JS
    assert jax.device_count() == R, jax.devices()
    mesh = shd.make_mesh_compat((R, 1), ("data", "model"))
    out = {}
    for track_m, fb in SPARSE_CASES:
        tag = f"sparse/{int(track_m)}{int(fb)}"
        _, step, opt = JS.make_sparse_embedding_step(
            N, D, lr=LR, hparams=JHP(**SPARSE_HP),
            track_first_moment=track_m, dp_axis="data", mesh=mesh,
            error_feedback=fb)
        step, table, state = jax.jit(step), jnp.asarray(_table0()), opt.init()
        for s, (ids, rows) in enumerate(_sparse_batches(int(fb)), start=1):
            table, state = step(table, state, jnp.asarray(ids.reshape(-1)),
                                jnp.asarray(rows.reshape(-1, D)))
            if s in (1, STEPS):
                out[f"{tag}/{s}/table"] = np.asarray(table)
                _put_tree(out, f"{tag}/{s}/state", state)
    for fb in (False, True):
        tag = f"serve/{int(fb)}"
        init, adapt = j_adapt(N, D, lr=LR, hparams=JHP(**SPARSE_HP),
                              dp_axis="data", mesh=mesh, error_feedback=fb)
        adapt, table, state = jax.jit(adapt), jnp.asarray(_table0(2)), init()
        for s, (ids, rows) in enumerate(_sparse_batches(2 + int(fb)),
                                        start=1):
            table, state = adapt(table, state, jnp.asarray(ids.reshape(-1)),
                                 jnp.asarray(rows.reshape(-1, D)))
        out[f"{tag}/table"] = np.asarray(table)
        _put_tree(out, f"{tag}/state", state)
    cfg = jx.MachConfig(**X_KW)
    for optimizer, fb in X_CASES:
        tag = f"extreme/{optimizer}"
        _, step, opts = jx.make_extreme_step(
            cfg, optimizer=optimizer, lr=LR, dp_axis="data", mesh=mesh,
            error_feedback=fb)
        step = jax.jit(step)
        params = jax.tree_util.tree_map(jnp.asarray, _extreme_params())
        state = {p: o.init() for p, o in opts.items()}
        for s, b in enumerate(_extreme_batches(), start=1):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            for k, v in m.items():
                out[f"{tag}/{s}/metric/{k}"] = np.asarray(v)
            if s in (1, STEPS):
                _put_tree(out, f"{tag}/{s}/params", params)
        _put_tree(out, f"{tag}/state", state)
    cfg = _lm_config(jconfigs)
    ts = JS.make_train_step(cfg, optimizer="cs_adam", dp_axis="data")
    with shd.active_mesh(mesh):
        params = ts.init_fn(jax.random.PRNGKey(0))
        state = ts.optimizer.init(params)
        _put_tree(out, "lm/params0", params)
        _put_tree(out, "lm/state0", state)
        step = jax.jit(ts.step_fn)
        for s, b in enumerate(_lm_batches(), start=1):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            for k, v in m.items():
                out[f"lm/{s}/metric/{k}"] = np.asarray(v)
    _put_tree(out, "lm/state", state)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    code = ("import sys, test_torch_dp as t; "
            "t._jax_reference(sys.argv[1])")
    run = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                         capture_output=True, text=True,
                         timeout=REFERENCE_TIMEOUT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    """{path: array} of one tree the reference wrote."""
    return {k[len(prefix) + 1:]: v for k, v in ref.items()
            if k.startswith(prefix + "/")}


def _hold_state(got_state, ref, prefix, tol):
    want = _tree(ref, prefix)
    got = {p: x.numpy() for p, x in leaf_paths(got_state)
           if p != "step"}
    assert sorted(got) == sorted(p for p in want if p != "step"), prefix
    for p in got:
        np.testing.assert_allclose(got[p], want[p], err_msg=f"{prefix}/{p}",
                                   **tol)


@pytest.mark.parametrize("track_m,feedback", SPARSE_CASES)
def test_sparse_step_matches_jax_dp(jref, track_m, feedback):
    tag = f"sparse/{int(track_m)}{int(feedback)}"
    g = _group()
    _, step, opt = TS.make_sparse_embedding_step(
        N, D, lr=LR, hparams=THP(**SPARSE_HP), track_first_moment=track_m,
        dp_axis=g, error_feedback=feedback, device="cpu")
    tables = [_t(_table0()) for _ in range(R)]
    states = [opt.init() for _ in range(R)]
    for s, (ids, rows) in enumerate(_sparse_batches(int(feedback)), start=1):
        tables, states = _dp_round(g, step, tables, states, ids, rows)
        _replicas_equal(tables, states)
        if s in (1, STEPS):
            tol = TOL if s == 1 else TRAJ
            np.testing.assert_allclose(tables[0].numpy(),
                                       jref[f"{tag}/{s}/table"], **tol)
            _hold_state(states[0], jref, f"{tag}/{s}/state", tol)
            assert int(states[0]["step"]) == s


@pytest.mark.parametrize("feedback", [False, True])
def test_serve_fleet_matches_jax_dp(jref, feedback):
    tag = f"serve/{int(feedback)}"
    g = _group()
    init, adapt = t_adapt(N, D, lr=LR, hparams=THP(**SPARSE_HP), dp_axis=g,
                          error_feedback=feedback, device="cpu")
    tables = [_t(_table0(2)) for _ in range(R)]
    states = [init() for _ in range(R)]
    for ids, rows in _sparse_batches(2 + int(feedback)):
        tables, states = _dp_round(g, adapt, tables, states, ids, rows)
        _replicas_equal(tables, states)
    assert states[0]["m"] is None
    np.testing.assert_allclose(tables[0].numpy(), jref[f"{tag}/table"],
                               **TRAJ)
    _hold_state(states[0], jref, f"{tag}/state", TRAJ)


def _shard_batch(b, r):
    """Replica r's part of a global extreme batch (negatives shared)."""
    per = X_BATCH // R
    return {"features": _t(b["features"][r * per:(r + 1) * per]),
            "labels": _t(b["labels"][r * per:(r + 1) * per]),
            "negatives": _t(b["negatives"])}


@pytest.mark.parametrize("optimizer,feedback", X_CASES)
def test_extreme_step_matches_jax_dp(jref, optimizer, feedback):
    """Metrics along the trajectory, the class head and every state leaf
    after 10 steps, the feature table after one (see
    ``test_torch_extreme.py`` for why not after 10)."""
    tag = f"extreme/{optimizer}"
    g = _group()
    _, step, opts = tx.make_extreme_step(
        tx.MachConfig(**X_KW), optimizer=optimizer, lr=LR, dp_axis=g,
        error_feedback=feedback, device="cpu")
    params = [convert.tree_from_numpy(_extreme_params(), "cpu")
              for _ in range(R)]
    states = [{p: o.init() for p, o in opts.items()} for _ in range(R)]
    for s, b in enumerate(_extreme_batches(), start=1):
        outs = g.run(step, [(params[r], states[r], _shard_batch(b, r))
                            for r in range(R)])
        params, states = [o[0] for o in outs], [o[1] for o in outs]
        for o in outs[1:]:
            for k in ("loss", "grad_norm", "dedup_ratio"):
                assert torch.equal(o[2][k], outs[0][2][k])
        for p in params[1:]:
            for top in p:
                assert torch.equal(p[top]["table"], params[0][top]["table"])
        for k, v in outs[0][2].items():
            np.testing.assert_allclose(float(v),
                                       jref[f"{tag}/{s}/metric/{k}"], **TRAJ)
        if s == 1:
            _hold_state(params[0], jref, f"{tag}/1/params", TOL)
    np.testing.assert_allclose(
        params[0]["class_head"]["table"].numpy(),
        jref[f"{tag}/{STEPS}/params/class_head/table"], **TRAJ)
    want = _tree(jref, f"{tag}/state")
    for path, st in states[0].items():
        for key in ("m", "v", "residual"):
            got = st[key]
            assert (got is None) == (f"{path}/{key}" not in want), key
            if got is not None:
                np.testing.assert_allclose(got.numpy(),
                                           want[f"{path}/{key}"],
                                           err_msg=f"{path}/{key}", **TRAJ)
            for other in states[1:]:
                if got is not None:
                    assert torch.equal(other[path][key], got)


def _lm_shard(b, r):
    per = LM_BATCH // R
    return {k: _t(v[r * per:(r + 1) * per]) for k, v in b.items()}


def _load_like(tree, flat):
    """``tree`` with every leaf overwritten by the reference's array at its
    path (None leaves stay None)."""
    for path, leaf in leaf_paths(tree):
        if path != "step":
            leaf.copy_(torch.tensor(flat[path]))
    return tree


def test_lm_step_matches_jax_dp(jref):
    """Per-step loss and grad norm and every optimizer-state leaf after
    three steps of qwen2-0.5b ``reduced(vocab_size=2048)`` under
    ``cs_adam`` (the params are not held element by element, as in
    ``test_torch_lm_step.py``); every replica ends with the same bits."""
    cfg = _lm_config(tconfigs)
    g = _group()
    ts = TS.make_train_step(cfg, optimizer="cs_adam", dp_axis=g, device="cpu")
    params = [_load_like(ts.init_fn(torch.Generator().manual_seed(0)),
                         _tree(jref, "lm/params0")) for _ in range(R)]
    states = [_load_like(ts.optimizer.init(p), _tree(jref, "lm/state0"))
              for p in params]
    for s, b in enumerate(_lm_batches(), start=1):
        outs = g.run(ts.step_fn, [(params[r], states[r], _lm_shard(b, r))
                                  for r in range(R)])
        params, states = [o[0] for o in outs], [o[1] for o in outs]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(outs[0][2][k]),
                                       jref[f"lm/{s}/metric/{k}"], **TRAJ)
            assert all(torch.equal(o[2][k], outs[0][2][k]) for o in outs)
    for p, st in zip(params[1:], states[1:]):
        for tree, first in ((p, params[0]), (st, states[0])):
            for (path, a), (_, b) in zip(leaf_paths(tree),
                                         leaf_paths(first)):
                assert torch.equal(a, b), path
    _hold_state(states[0], jref, "lm/state", TRAJ)


def test_lm_dp_step_is_the_global_batch_step():
    """pmean'd per-replica gradients are the global batch's: the DP step
    on R shards against the single-device step on their concatenation."""
    cfg = _lm_config(tconfigs)
    g = _group()
    dp = TS.make_train_step(cfg, optimizer="cs_adam", dp_axis=g, device="cpu")
    one = TS.make_train_step(cfg, optimizer="cs_adam", device="cpu")
    p0 = one.init_fn(torch.Generator().manual_seed(3))
    p1 = convert.tree_from_numpy(convert.tree_to_numpy(p0), "cpu")
    s1 = one.optimizer.init(p1)
    params = [convert.tree_from_numpy(convert.tree_to_numpy(p0), "cpu")
              for _ in range(R)]
    states = [dp.optimizer.init(p) for p in params]
    for b in _lm_batches()[:2]:
        outs = g.run(dp.step_fn, [(params[r], states[r], _lm_shard(b, r))
                                  for r in range(R)])
        params, states = [o[0] for o in outs], [o[1] for o in outs]
        p1, s1, m1 = one.step_fn(p1, s1, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(outs[0][2][k]), float(m1[k]),
                                       **TOL)
    _hold_state_close(states[0], s1)


def _hold_state_close(got, want):
    w = dict(leaf_paths(want))
    for path, leaf in leaf_paths(got):
        np.testing.assert_allclose(leaf.numpy(), w[path].numpy(),
                                   err_msg=path, **TRAJ)
