"""Parity of the port's dense-path ``update_read`` and batch sketch ops
with the JAX reference.

Tolerance rtol=1e-5, atol=1e-6 for one call (``TOL``): the forms with a
product can round differently where XLA:CPU fuses a multiply and an add,
which the port does not.  The batch QUERY has no product and is held to
the bit, as is the UPDATE where every sketch cell is written once.

Semantics: the port's ``tiled`` (B3) has whole-batch semantics, so it is
held to the reference's ``xla``; against the reference's Pallas kernel
(``interpret``), which streams across tiles, only on identity-hashed
(collision-free) specs.  On the CPU every port backend runs its plain
PyTorch version.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as TK
from repro.core import sketch as jcs
from repro.core import stores as jstores
from repro.kernels import ops as jops
from repro_torch.core import sketch as tcs
from repro_torch.core import stores as tstores
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cs_ema_tiled import cs_ema_tiled, ema_form
from repro_torch.kernels.cs_query import cs_query
from repro_torch.kernels.cs_update import bucket_csr, cs_update

TOL = dict(rtol=1e-5, atol=1e-6)
# (beta, scale) of the three ema_delta forms: Adam, Adagrad, momentum
FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
         "momentum": (0.9, 1.0)}
KINDS = {"sketch": (jstores.CountSketchStore, tstores.CountSketchStore),
         "countmin": (jstores.CountMinStore, tstores.CountMinStore)}
# (port backend, reference backend it is held to)
PAIRS = [("ref", "ref"), ("xla", "xla"), ("tiled", "xla")]


def _stores(kind, n=384, d=8, identity=False, seed=0):
    jcls, tcls = KINDS[kind]
    kw = dict(compression=8.0, width_multiple=16, identity=identity,
              seed=seed)
    return (jcls(**kw).bind("tab", (n, d), jnp.float32),
            tcls(**kw).bind("tab", (n, d)))


def _inputs(spec, n, masked, seed):
    rng = np.random.RandomState(seed)
    S = rng.randn(*spec.shape).astype(np.float32)
    if not spec.signed:
        S = np.abs(S)
    x = rng.randn(n, spec.dim).astype(np.float32)
    mask = (rng.rand(n, 1) > 0.3).astype(np.float32) if masked else None
    return S, x, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("ours,theirs", PAIRS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_update_read_grid_matches_reference(kind, form, masked, ours,
                                            theirs):
    """Whole-table update_read (rows=None, the dense path), every store
    kind, ema_delta form and mask setting, under real hashing: buckets
    collide about 8 rows to one."""
    beta, scale = FORMS[form]
    js, ts = _stores(kind, seed=len(form))
    S, x, mask = _inputs(ts.spec, 384, masked, seed=len(form) + masked)
    jS, jest = dataclasses.replace(js, backend=theirs).update_read(
        _j(S), _j(x), beta, scale=scale, mask=_j(mask))
    tS, test = dataclasses.replace(ts, backend=ours).update_read(
        _t(S), _t(x), beta, scale=scale, mask=_t(mask))
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), **TOL)


@pytest.mark.parametrize("ours", ["ref", "xla", "tiled"])
def test_update_read_on_a_row_subset(ours):
    """Explicit rows (hashed per call, not the cached dense table) and the
    composed form (backend None) agree with the reference."""
    js, ts = _stores("sketch", seed=4)
    S, x, mask = _inputs(ts.spec, 64, True, seed=4)
    rows = np.random.RandomState(5).choice(384, 64, replace=False).astype(
        np.int32)
    want = js.update_read(_j(S), _j(x), 0.9, rows=_j(rows), mask=_j(mask))
    for store in (ts, dataclasses.replace(ts, backend=ours)):
        got = store.update_read(_t(S), _t(x), 0.9, rows=_t(rows),
                                mask=_t(mask))
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("form,masked", [("adam", True), ("momentum", False),
                                         ("adagrad", True)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tiled_matches_reference_kernel_collision_free(kind, form, masked):
    """Identity hashing: no two rows share a bucket, so the reference's
    streaming Pallas kernel (interpret mode) and the port's whole-batch
    tiled agree."""
    beta, scale = FORMS[form]
    js, ts = _stores(kind, n=64, identity=True)
    S, x, mask = _inputs(ts.spec, 64, masked, seed=7)
    want = dataclasses.replace(js, backend="interpret").update_read(
        _j(S), _j(x), beta, scale=scale, mask=_j(mask))
    got = dataclasses.replace(ts, backend="tiled").update_read(
        _t(S), _t(x), beta, scale=scale, mask=_t(mask))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert cs_ema_tiled.launches == 0          # the CPU runs no kernel


def test_ema_form_follows_ema_delta():
    """The kernel's host-side form choice takes the branch ema_delta
    takes, including the Adam form with a unit scale (beta 0)."""
    assert ema_form(0.999, 1.0 - 0.999) == (0, False)
    assert ema_form(0.0, 1.0) == (0, True)
    assert ema_form(1.0, 1.0) == (1, True)
    assert ema_form(1.0, 0.5) == (1, False)
    assert ema_form(0.9, 1.0) == (2, True)
    assert ema_form(0.9, 0.3) == (2, False)


def test_dense_addressing_is_cached_on_the_device():
    spec = tcs.for_param((384, 8), compression=8.0, width_multiple=16,
                         seed=3)
    b, s = tops._cached_addressing(spec, 384, torch.device("cpu"))
    assert tops._cached_addressing(spec, 384, torch.device("cpu"))[0] is b
    ids = torch.arange(384, dtype=torch.int32)
    assert torch.equal(b, spec.family.bucket(ids))
    assert torch.equal(s, spec.family.sign(ids))


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_csr_lists_each_bucket_in_item_order(seed):
    rng = np.random.RandomState(seed)
    width, k = 16, 50
    b = rng.randint(0, width, (3, k)).astype(np.int32)
    order, starts = bucket_csr(torch.from_numpy(b), width)
    assert order.dtype == starts.dtype == torch.int32
    assert tuple(starts.shape) == (3, width + 1)
    for j in range(3):
        for w in range(width):
            items = order[j, starts[j, w]:starts[j, w + 1]].tolist()
            assert items == np.flatnonzero(b[j] == w).tolist()


def test_update_read_registry_rows():
    for kind in ("sketch", "countmin"):
        assert TK.registry.backends(kind, "update_read") == (
            "ref", "xla", "tiled")
        assert TK.registry.resolve(kind, "update_read", "auto",
                                   torch.device("cuda")) == "tiled"
        assert TK.registry.resolve(kind, "update_read", None,
                                   torch.device("cpu")) == "xla"
    assert JK.registry.backends("sketch", "update_read") == (
        "ref", "xla", "tiled", "interpret")


# ---------------------------------------------------------------- B4, B5
def _sketch_case(signed, depth, k, d, seed, n=200):
    spec_kw = dict(compression=4.0, depth=depth, signed=signed,
                   width_multiple=16, seed=seed)
    jspec = jcs.for_param((n, d), **spec_kw)
    tspec = tcs.for_param((n, d), **spec_kw)
    rng = np.random.RandomState(seed)
    S = rng.randn(*tspec.shape).astype(np.float32)
    ids = rng.randint(0, n, k).astype(np.int32)
    delta = rng.randn(k, d).astype(np.float32)
    return jspec, tspec, S, ids, delta


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("signed", [True, False])
def test_sketch_query_bit_equal(signed, depth):
    jspec, tspec, S, ids, _ = _sketch_case(signed, depth, 24, 16, depth)
    want = jops.sketch_query(jspec, _j(S), _j(ids))
    got = tops.sketch_query(tspec, _t(S), _t(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cs_query.launches == 0


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("signed", [True, False])
def test_sketch_update_bit_equal(signed, depth):
    """Duplicate ids and colliding buckets accumulate in item order."""
    jspec, tspec, S, ids, delta = _sketch_case(signed, depth, 32, 16,
                                               depth + 10, n=64)
    want = jops.sketch_update(jspec, _j(S), _j(ids), _j(delta))
    got = tops.sketch_update(tspec, _t(S), _t(ids), _t(delta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cs_update.launches == 0


@pytest.mark.parametrize("signed", [True, False])
def test_sketch_ops_match_reference_kernels(signed):
    """The reference's Pallas QUERY and UPDATE kernels (interpret mode)
    at k 32, d 64: QUERY to the bit, UPDATE within one call's tolerance
    (its kernel seeds a bucket from the old row and accumulates)."""
    jspec, tspec, S, ids, delta = _sketch_case(signed, 3, 32, 64, 21)
    want_q = jops.sketch_query(jspec, _j(S), _j(ids), force="pallas")
    np.testing.assert_array_equal(
        tops.sketch_query(tspec, _t(S), _t(ids)).numpy(), np.asarray(want_q))
    want_u = jops.sketch_update(jspec, _j(S), _j(ids), _j(delta),
                                force="pallas")
    np.testing.assert_allclose(
        tops.sketch_update(tspec, _t(S), _t(ids), _t(delta)).numpy(),
        np.asarray(want_u), **TOL)
