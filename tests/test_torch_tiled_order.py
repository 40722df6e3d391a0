"""The ``tiled`` step's schedule on the card, modelled on the CPU.

On CUDA tensors ``ops.adam_rows_tiled`` runs three pieces with no
atomics: the dedup segment sum as B5's run scatter at depth 1 over
dedup's own sort (``kernels/dedup.py``, ``csrc/cs_update.cu``); B1's
read over the live slots, each slot's update written at its first input
position and a zero row at every later duplicate
(``csrc/cs_adam_tiled.cu``); and the run scatter of M and V over the
bucket CSR of their stacked buckets, each bucket's live slots (slot <
n_valid, a prefix of the run) added in slot order from the old cell (the
read writes the cell of a run of one slot itself, with the same
operations).
``_tiled_model`` plays that schedule out with the kernels' operations
and must give ``dedup_rows`` + ``cs_adam_tiled_plain`` + ``scatter_back``
run on the CPU to the bit: width 16 (heavy collisions), zipf ids whose
head repeats 200 times or more, dedup padding (n_valid < k), β₁ = 0,
depth 1 and 3.  The port's step is also held to the JAX package's
``adam_rows_xla`` (rtol 1e-5, atol 1e-6, as
``tests/test_torch_backends.py``), and the hash families, whose
parameters the port now keeps on each device, to the JAX families bit
for bit.  Torch runs on one CPU thread, as in ``test_torch_dense.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
from repro.core import hashing as jh
from repro.core import sketch as jcs
from repro_torch.core import hashing as th
from repro_torch.core import sketch as tcs
from repro_torch.kernels import dedup as dd
from repro_torch.kernels import ops
from repro_torch.kernels.cs_update import bucket_csr_plain

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)          # as tests/test_torch_backends.py
HYP = dict(lr=1e-2, b2=0.999, eps=1e-8)
N, K, D = 5_000, 3_000, 16


def _specs(depth, width, seed=0):
    kw = dict(depth=depth, width=width, dim=D)
    return ((jcs.SketchSpec(signed=True, seed=10 + seed, **kw),
             jcs.SketchSpec(signed=False, seed=20 + seed, **kw)),
            (tcs.SketchSpec(signed=True, seed=10 + seed, **kw),
             tcs.SketchSpec(signed=False, seed=20 + seed, **kw)))


def _inputs(depth, width, seed):
    """Sketch states and a zipf batch whose head id repeats 200+ times."""
    rng = np.random.RandomState(seed)
    M = (rng.randn(depth, width, D) * 0.1).astype(np.float32)
    V = np.abs(rng.randn(depth, width, D) * 0.01).astype(np.float32)
    ids = ((rng.zipf(1.1, K) - 1) % N).astype(np.int32)
    g = rng.randn(K, D).astype(np.float32)
    return M, V, ids, g


def _median(v):
    """The kernel's median over depth (cs_common.cuh::median)."""
    if len(v) == 1:
        return v[0]
    hi = torch.maximum(torch.maximum(v[0], v[1]), v[2])
    lo = torch.minimum(torch.minimum(v[0], v[1]), v[2])
    return v[0] + v[1] + v[2] - hi - lo


def _add_runs(S, x, signs, order, starts, n_valid, by_read):
    """Runs of the CSR, one hash row j and bucket at a time: with
    ``by_read`` the runs of one item (B1's read writes them), else the
    others (the run scatter).  The run's items ascend (a stable CSR), its
    live prefix (items < n_valid) is added from the old cell, item after
    item."""
    depth, width = starts.shape[0], starts.shape[1] - 1
    for j in range(depth):
        for b in range(width):
            items = order[j, starts[j, b]:starts[j, b + 1]].tolist()
            assert items == sorted(items)
            live = [r for r in items if r < n_valid]
            assert items[:len(live)] == live
            if not live or (len(items) == 1) != by_read:
                continue
            acc = S[j, b].clone()
            for r in live:
                s = signs[j, r] if signs is not None else torch.tensor(1.0)
                acc = acc + s * x[r]
            S[j, b] = acc


def _tiled_model(specs, M, V, ids, g, step, b1):
    """The card's ``tiled`` schedule in plain PyTorch; updates M and V in
    place and returns (M, V, per-position update)."""
    spec_m, spec_v = specs
    k = ids.shape[0]
    eta, bc1, bc2 = ops._adam_hypers(step, HYP["lr"], b1, HYP["b2"])
    # 1. dedup: the segment sum as a depth-1 run scatter over the sort
    sorted_ids, order = torch.sort(ids, stable=True)
    is_start = torch.ones(k, dtype=torch.int64)
    is_start[1:] = (sorted_ids[1:] != sorted_ids[:-1]).long()
    seg = torch.cumsum(is_start, 0) - 1
    starts = torch.full((k + 1,), k, dtype=torch.int64).scatter_reduce_(
        0, seg, torch.arange(k), reduce="amin")
    inv = torch.empty(k, dtype=torch.int64).scatter_(0, order, seg)
    summed = torch.zeros((1, k, D))
    _add_runs(summed, g, None, order[None], starts[None], k, False)
    _add_runs(summed, g, None, order[None], starts[None], k, True)
    rows = summed[0]
    batch = dd.dedup_rows(ids, g)
    assert torch.equal(rows, batch.rows)
    nv = int(batch.n_unique)
    first_pos = batch.first_pos.long()
    # 2. the read over live slots, written at first positions
    bv = spec_v.family.bucket(batch.unique_ids).long()
    depth = bv.shape[0]
    v_old = [V[j][bv[j, :nv]] for j in range(depth)]
    v_old = v_old[0] if depth == 1 else torch.minimum(
        torch.minimum(v_old[0], v_old[1]), v_old[2])
    gl = rows[:nv]
    dm = dv = None
    if M is not None:
        bm = spec_m.family.bucket(batch.unique_ids).long()
        sm = spec_m.family.sign(batch.unique_ids)
        m_old = _median([M[j][bm[j, :nv]] * sm[j, :nv, None]
                         for j in range(depth)])
        dm = torch.zeros((k, D))
        dm[:nv] = (1.0 - b1) * (gl - m_old)
        mhat = (m_old + dm[:nv]) / torch.tensor(bc1)
    else:
        mhat = gl
    dv = torch.zeros((k, D))
    dv[:nv] = (1.0 - HYP["b2"]) * (gl * gl - v_old)
    vhat = torch.clamp_min(v_old + dv[:nv], 0.0) / torch.tensor(bc2)
    upd = torch.full((k, D), float("nan"))
    upd[first_pos[:nv]] = (-eta) * mhat / (torch.sqrt(vhat) + HYP["eps"])
    later = first_pos[inv] != torch.arange(k)
    upd[later] = 0.0
    assert not upd.isnan().any()
    # the read writes the cells whose run holds one slot; then 3. the run
    # scatter of M and V over the stacked buckets' CSR adds the rest
    both = (torch.cat([bm, bv]) if M is not None else bv).to(torch.int32)
    order2, starts2, _ = bucket_csr_plain(both, spec_v.width)
    for by_read in (True, False):
        if M is not None:
            _add_runs(M, dm, sm, order2[:depth], starts2[:depth], nv, by_read)
        _add_runs(V, dv, None, order2[-depth:], starts2[-depth:], nv,
                  by_read)
    return M, V, upd


CASES = [(depth, width, track_m) for depth in (1, 3) for width in (16, 256)
         for track_m in (True, False)]


@pytest.mark.parametrize("depth,width,track_m", CASES)
def test_model_of_the_card_schedule_is_bit_equal(depth, width, track_m):
    specs_j, specs_t = _specs(depth, width, seed=depth)
    M, V, ids, g = _inputs(depth, width, seed=width + depth)
    assert np.bincount(ids).max() >= 200      # a long run in the dedup sum
    b1 = 0.9 if track_m else 0.0
    t = torch.from_numpy
    want = ops.adam_rows_tiled(specs_t[0] if track_m else None, specs_t[1],
                               t(M.copy()) if track_m else None,
                               t(V.copy()), t(ids), t(g), 3, b1=b1, **HYP)
    got = _tiled_model(specs_t, t(M.copy()) if track_m else None,
                       t(V.copy()), t(ids), t(g), 3, b1)
    assert int(dd.dedup_rows(t(ids), t(g)).n_unique) < K   # padding slots
    for a, c in zip(want, got):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, c)


@pytest.mark.parametrize("depth,width,track_m", CASES)
def test_tiled_agrees_with_the_reference_xla(depth, width, track_m):
    specs_j, specs_t = _specs(depth, width, seed=depth)
    M, V, ids, g = _inputs(depth, width, seed=width + depth + 1)
    b1 = 0.9 if track_m else 0.0
    want = JK.adam_rows(specs_j[0] if track_m else None, specs_j[1],
                        jnp.asarray(M) if track_m else None, jnp.asarray(V),
                        jnp.asarray(ids), jnp.asarray(g),
                        jnp.asarray(3, jnp.int32), backend="xla", b1=b1,
                        **HYP)
    t = torch.from_numpy
    got = ops.adam_rows_tiled(specs_t[0] if track_m else None, specs_t[1],
                              t(M.copy()) if track_m else None, t(V.copy()),
                              t(ids), t(g), 3, b1=b1, **HYP)
    for a, c in zip(want, got):
        assert (a is None) == (c is None)
        if a is not None:
            np.testing.assert_allclose(c.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
@pytest.mark.parametrize("depth,width", [(3, 10_240), (1, 16), (5, 1_000)])
def test_cached_hash_parameters_match_the_reference(seed, depth, width):
    """Buckets and signs with the parameters kept per (family, device):
    the first call and the cached ones equal the JAX family's, and the
    cache hands back the same tensors."""
    rng = np.random.RandomState(seed % 1000)
    ids = rng.randint(0, 1 << 20, 301).astype(np.int32)
    ids[:3] = (-1, 0, np.iinfo(np.int32).max)
    jf = jh.HashFamily(seed=seed, depth=depth, width=width)
    tf = th.HashFamily(seed=seed, depth=depth, width=width)
    want_b = np.asarray(jf.bucket(jnp.asarray(ids)))
    want_s = np.asarray(jf.sign(jnp.asarray(ids)))
    for _ in range(2):
        np.testing.assert_array_equal(tf.bucket(torch.from_numpy(ids)),
                                      want_b)
        np.testing.assert_array_equal(tf.sign(torch.from_numpy(ids)), want_s)
    a, b = th._params_on(tf, torch.device("cpu"))
    assert a is th._params_on(th.HashFamily(seed=seed, depth=depth,
                                            width=width),
                              torch.device("cpu"))[0]
    np.testing.assert_array_equal(a.numpy(), tf.params[:, 0])
    np.testing.assert_array_equal(b.numpy(), tf.params[:, 1])
