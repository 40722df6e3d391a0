"""The stable bucket CSR (``cs_update.bucket_csr``, ``bucket_prev``) and
B2's window rule, on the CPU.

``bucket_csr`` is held to numpy's stable argsort, ``bucket_prev`` to a
Python loop.  B2's CUDA kernel (``csrc/cs_adam.cu``) reads a cell early
and takes it from the values it wrote itself when an item inside the
window of ``L`` items wrote that cell last; ``_window_model`` below plays
that rule out with real early loads (a copy of the cells taken ``L``
items ahead, before the stores in between) and must give the per-item
plain version ``ref.adam_fused_ref`` to the bit.  The bookkeeping is
numpy; the arithmetic is the plain version's own PyTorch operations, in
its order, so that the two agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sketch import median_rows, min_rows
from repro_torch.kernels import cs_adam, ref
from repro_torch.kernels.cs_update import (bucket_csr, bucket_csr_plain,
                                           bucket_prev)

KW = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)


def _buckets(case, rng):
    if case == "empty":
        return np.zeros((3, 0), np.int32), 16
    if case == "width1":
        return np.zeros((3, 40), np.int32), 1
    if case == "one_bucket":
        return np.full((2, 50), 7, np.int32), 16
    if case == "last_bucket":
        return rng.randint(29, 32, (3, 60)).astype(np.int32), 32
    return rng.randint(0, 24, (3, 200)).astype(np.int32), 24


CASES = ["empty", "width1", "one_bucket", "last_bucket", "random"]


@pytest.mark.parametrize("case", CASES)
def test_bucket_csr_is_a_stable_sort(case):
    b, width = _buckets(case, np.random.RandomState(3))
    order, starts = bucket_csr(torch.from_numpy(b), width)
    assert order.dtype == starts.dtype == torch.int32
    assert tuple(order.shape) == b.shape
    assert tuple(starts.shape) == (b.shape[0], width + 1)
    for j in range(b.shape[0]):
        want = np.argsort(b[j], kind="stable")
        np.testing.assert_array_equal(order[j].numpy(), want)
        edges = np.searchsorted(b[j][want], np.arange(width + 1))
        np.testing.assert_array_equal(starts[j].numpy(), edges)


def _prev_loop(b):
    prev = np.full(b.shape, -1, np.int64)
    for j in range(b.shape[0]):
        last = {}
        for i, x in enumerate(b[j]):
            prev[j, i] = last.get(int(x), -1)
            last[int(x)] = i
    return prev


@pytest.mark.parametrize("case", CASES)
def test_bucket_prev_is_the_last_earlier_item_in_the_bucket(case):
    b, width = _buckets(case, np.random.RandomState(4))
    prev = bucket_prev(torch.from_numpy(b), width)
    assert prev.dtype == torch.int32
    np.testing.assert_array_equal(prev.numpy(), _prev_loop(b))
    assert torch.equal(prev, bucket_csr_plain(torch.from_numpy(b), width)[2])


def _window_model(M, V, bm, sm, bv, g, *, L, lr, b1, b2, eps, bc1, bc2,
                  reach=0):
    """B2's schedule: the cells of item i+L are loaded while item i
    computes, before its stores; item i takes row j's cell from the ring
    of the last L written values (slot p mod L, which item p + L
    overwrites after its reads) when prev[j, i] >= i - L + reach, else
    the early load.  ``reach`` 0 is the kernel's rule; other values are
    wrong rules, for the test that shows the model catches them.  Updates
    M and V in place; returns (M, V, upd)."""
    k, depth = g.shape[0], V.shape[0]
    j_idx = torch.arange(depth)
    pv = _prev_loop(bv.numpy())
    pm = _prev_loop(bm.numpy()) if M is not None else None
    early, ring = {}, [None] * L

    def load(i):
        early[i] = (None if M is None else M[j_idx, bm[:, i].long()].clone(),
                    V[j_idx, bv[:, i].long()].clone())

    def current(raw, prev, i, slot):
        for j in range(raw.shape[0]):
            p = prev[j, i]
            if p >= 0 and p >= i - L + reach:
                raw[j] = ring[p % L][slot][j]
        return raw

    upd = torch.empty_like(g)
    for i in range(min(L, k)):
        load(i)
    for i in range(k):
        if i + L < k:
            load(i + L)
        raw_m, raw_v = early.pop(i)
        g_i = g[i]
        new_m = None
        if M is not None:
            raw = current(raw_m, pm, i, 0)
            s_i = sm[:, i][:, None]
            m_old = median_rows(list(raw * s_i))
            dm = (1.0 - b1) * (g_i - m_old)
            new_m = raw + s_i * dm[None]
            M[j_idx, bm[:, i].long()] = new_m
            mhat = ref.true_div(m_old + dm, bc1)
        else:
            mhat = g_i
        raw_v = current(raw_v, pv, i, 1)
        v_old = min_rows(list(raw_v))
        dv = (1.0 - b2) * (g_i * g_i - v_old)
        new_v = raw_v + dv[None]
        V[j_idx, bv[:, i].long()] = new_v
        vhat = ref.true_div(torch.clamp_min(v_old + dv, 0.0), bc2)
        upd[i] = -lr * mhat / (torch.sqrt(vhat) + eps)
        ring[i % L] = (new_m, new_v)
    return M, V, upd


def _stream_case(depth, k, track_m, seed, width=8, d=12):
    rng = np.random.RandomState(seed)
    M = torch.from_numpy(rng.randn(depth, width, d).astype(np.float32)) \
        if track_m else None
    V = torch.from_numpy(np.abs(rng.randn(depth, width, d)).astype(
        np.float32))
    # zipf ids hashed into a narrow sketch: same-bucket items at every
    # distance, the window's edges included
    ids = rng.zipf(1.3, k)
    bm = torch.from_numpy(((ids[None] * np.arange(1, depth + 1)[:, None]
                            * 7 + 3) % width).astype(np.int32))
    bv = torch.from_numpy(((ids[None] * np.arange(1, depth + 1)[:, None]
                            * 5 + 1) % width).astype(np.int32))
    sm = torch.from_numpy(np.where(rng.rand(depth, k) < 0.5, -1.0, 1.0)
                          .astype(np.float32))
    g = torch.from_numpy(rng.randn(k, d).astype(np.float32))
    return (M, V, bm if track_m else None, sm if track_m else None, bv, g)


def _clone(xs):
    return [None if x is None else x.clone() for x in xs]


@pytest.mark.parametrize("L", [1, 2, cs_adam.WINDOW, 8, 32])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_window_rule_is_bit_equal_to_the_per_item_plain_version(
        L, depth, track_m):
    k = 3 * 32 + 7          # not a multiple of the kernel's 32-item tile
    args = _stream_case(depth, k, track_m, seed=L + 10 * depth)
    kw = dict(KW, b1=0.9 if track_m else 0.0)
    want = ref.adam_fused_ref(*_clone(args), **kw)
    got = _window_model(*_clone(args), L=L, **kw)
    for a, c in zip(want, got):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, c)


@pytest.mark.parametrize("reach", [1, -1])
def test_window_model_catches_an_off_by_one_rule(reach):
    """Forwarding one item too few (reach 1: an item exactly L back is
    read from the stale early load) or one too many (reach -1: the slot
    of an item L+1 back has been overwritten in the ring) changes the
    result."""
    args = _stream_case(3, 120, True, seed=5)
    kw = dict(KW, b1=0.9)
    want = ref.adam_fused_ref(*_clone(args), **kw)
    got = _window_model(*_clone(args), L=4, reach=reach, **kw)
    assert not all(torch.equal(a, c) for a, c in zip(want, got))
