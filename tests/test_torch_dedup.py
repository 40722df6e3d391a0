"""Parity of the port's dedup pre-pass with the JAX reference.

The integer outputs must match to the bit.  The segment sums match to the
bit on the CPU as well: both add each segment's rows in sorted order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dedup as jdd
from repro_torch.kernels import dedup as tdd


def _both(ids, rows):
    return (jdd.dedup_rows(jnp.asarray(ids), jnp.asarray(rows)),
            tdd.dedup_rows(torch.from_numpy(ids), torch.from_numpy(rows)))


CASES = [(1, 24, 8), (2, 64, 64), (3, 48, 4000), (4, 1, 5), (5, 33, 2)]


@pytest.mark.parametrize("seed,k,hi", CASES)
def test_dedup_outputs_bit_equal(seed, k, hi):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, hi, k).astype(np.int32)
    rows = rng.randn(k, 16).astype(np.float32)
    j, t = _both(ids, rows)
    for name in ("unique_ids", "inv", "first_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), err_msg=name)
        assert getattr(t, name).dtype == torch.int32
    assert int(j.n_unique) == int(t.n_unique)
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.rows), t.rows.numpy())


@pytest.mark.parametrize("seed,k,hi", CASES)
def test_scatter_and_gather_back_placement(seed, k, hi):
    rng = np.random.RandomState(seed + 10)
    ids = rng.randint(0, hi, k).astype(np.int32)
    rows = rng.randn(k, 16).astype(np.float32)
    out = rng.randn(k, 16).astype(np.float32)
    j, t = _both(ids, rows)
    np.testing.assert_array_equal(
        np.asarray(jdd.scatter_back(j, jnp.asarray(out))),
        tdd.scatter_back(t, torch.from_numpy(out)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jdd.gather_back(j, jnp.asarray(out))),
        tdd.gather_back(t, torch.from_numpy(out)).numpy())


@pytest.mark.parametrize("multiple", [1, 8, 16])
def test_pad_to_multiple_then_scatter_back(multiple):
    rng = np.random.RandomState(multiple)
    ids = rng.randint(0, 20, 21).astype(np.int32)
    rows = rng.randn(21, 8).astype(np.float32)
    j, t = _both(ids, rows)
    jp, tp = jdd.pad_to_multiple(j, multiple), tdd.pad_to_multiple(t, multiple)
    for name in ("unique_ids", "first_pos", "rows"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy(), err_msg=name)
    out = rng.randn(tp.unique_ids.shape[0], 8).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jdd.scatter_back(jp, jnp.asarray(out))),
        tdd.scatter_back(tp, torch.from_numpy(out)).numpy())


def test_empty_batch():
    t = tdd.dedup_rows(torch.zeros((0,), dtype=torch.int32),
                       torch.zeros((0, 4)))
    assert t.unique_ids.shape == (0,) and int(t.n_unique) == 0
