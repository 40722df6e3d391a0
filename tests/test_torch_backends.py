"""Parity of the port's sparse-rows CS-Adam backends with the JAX reference.

Tolerance rtol=1e-5, atol=1e-6 on float results, for two measured
reasons: XLA:CPU fuses ``g*g - v`` into one fused multiply-add where the
port rounds the product first, and the reference takes ``b**t`` in
float32 where the port takes it in float64 (one ulp apart at some steps).
Integer addressing is held to the bit elsewhere (test_torch_core.py), and
the first moment after one ``xla`` step is bit-equal here, since its path
has no product to fuse.

Semantics: the port's ``tiled`` runs one batch for the whole step, so it
is held to the reference's ``xla`` backend; the port's ``ref`` and
``stream`` follow the per-item order and are held to the reference's
``ref``.  On the CPU every port backend runs its plain PyTorch version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as TK
from repro.core import sketch as jcs
from repro.kernels import ref as jref
from repro_torch.core import sketch as tcs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cs_adam import cs_adam_fused
from repro_torch.kernels.cs_adam_tiled import cs_adam_tiled

TOL = dict(rtol=1e-5, atol=1e-6)
HYP = dict(lr=1e-2, b2=0.999, eps=1e-8)


def _specs(n, d, depth, *, identity=False, seed=0):
    kw = dict(compression=4.0, depth=depth, width_multiple=16,
              identity=identity)
    return ((jcs.for_param((n, d), signed=True, seed=10 + seed, **kw),
             jcs.for_param((n, d), signed=False, seed=20 + seed, **kw)),
            (tcs.for_param((n, d), signed=True, seed=10 + seed, **kw),
             tcs.for_param((n, d), signed=False, seed=20 + seed, **kw)))


def _inputs(spec, k, n, track_m, seed, unique=False):
    rng = np.random.RandomState(seed)
    M = rng.randn(*spec.shape).astype(np.float32) if track_m else None
    V = np.abs(rng.randn(*spec.shape)).astype(np.float32)
    ids = (rng.permutation(n)[:k] if unique
           else rng.randint(0, n // 4, k)).astype(np.int32)
    g = rng.randn(k, spec.dim).astype(np.float32)
    return M, V, ids, g


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _run_jax(backend, specs, M, V, ids, g, b1, step=2):
    spec_m, spec_v = specs
    return JK.adam_rows(spec_m if M is not None else None, spec_v,
                        None if M is None else jnp.asarray(M),
                        jnp.asarray(V), jnp.asarray(ids), jnp.asarray(g),
                        jnp.asarray(step, jnp.int32), backend=backend,
                        b1=b1, **HYP)


def _run_torch(backend, specs, M, V, ids, g, b1, step=2):
    spec_m, spec_v = specs
    return TK.adam_rows(spec_m if M is not None else None, spec_v, _t(M),
                        _t(V), _t(ids), _t(g), torch.tensor(step), b1=b1,
                        backend=backend, **HYP)


def _close(want, got):
    for a, b in zip(want, got):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# (port backend, reference backend it is held to)
PAIRS = [("ref", "ref"), ("stream", "ref"), ("xla", "xla"), ("tiled", "xla")]


@pytest.mark.parametrize("ours,theirs", PAIRS)
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("b1", [0.9, 0.0])
def test_adam_rows_matches_reference_with_duplicates(ours, theirs, depth, b1):
    n, d, k = 256, 64, 40                   # ids drawn from n/4: duplicates
    jspecs, tspecs = _specs(n, d, depth, seed=depth)
    M, V, ids, g = _inputs(tspecs[1], k, n, b1 > 0, seed=depth)
    assert len(set(ids.tolist())) < k
    _close(_run_jax(theirs, jspecs, M, V, ids, g, b1),
           _run_torch(ours, tspecs, M, V, ids, g, b1))


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("b1", [0.9, 0.0])
def test_tiled_matches_reference_kernel_collision_free(depth, b1):
    """Identity hashing with unique ids: the reference's Pallas kernel (in
    interpret mode) and the port's whole-batch tiled agree."""
    n, d, k = 64, 32, 16
    jspecs, tspecs = _specs(n, d, depth, identity=True, seed=depth)
    M, V, ids, g = _inputs(tspecs[1], k, n, b1 > 0, seed=depth + 5,
                           unique=True)
    _close(_run_jax("interpret", jspecs, M, V, ids, g, b1),
           _run_torch("tiled", tspecs, M, V, ids, g, b1))


@pytest.mark.parametrize("depth", [1, 3])
def test_first_moment_bit_equal_after_one_xla_step(depth):
    n, d, k = 256, 64, 48
    jspecs, tspecs = _specs(n, d, depth, seed=7)
    M, V, ids, g = _inputs(tspecs[1], k, n, True, seed=7)
    jM, _, _ = _run_jax("xla", jspecs, M, V, ids, g, 0.9)
    tM, _, _ = _run_torch("xla", tspecs, M, V, ids, g, 0.9)
    np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))


def _jax_whole_batch(M, V, bm, sm, bv, g, *, lr, b1, b2, eps, bc1, bc2,
                     n_valid):
    """The reference's tiled semantics with one tile spanning the batch."""
    k = g.shape[0]
    valid = (np.arange(k) < n_valid).astype(np.float32)[:, None]
    if M is not None:
        m_old = jref.cs_query_ref(M, bm, sm)
        dm = (1 - b1) * (g - m_old) * valid
        M = jref.cs_update_ref(M, bm, sm, dm)
        mhat = (m_old + dm) / bc1
    else:
        mhat = g
    v_old = jref.cs_query_ref(V, bv, None)
    dv = (1 - b2) * (g * g - v_old) * valid
    V = jref.cs_update_ref(V, bv, None, dv)
    upd = valid * (-lr) * mhat / (jnp.sqrt(jnp.maximum(v_old + dv, 0.0) / bc2)
                                  + eps)
    return M, V, upd


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_cs_adam_tiled_plain_under_heavy_collisions(depth, track_m):
    """Width 16, k 32, n_valid k-3 (the reference's collision envelope
    case): the wrapper's CPU path against a whole-batch JAX oracle."""
    width, d, k = 16, 64, 32
    rng = np.random.RandomState(depth)
    M = rng.randn(depth, width, d).astype(np.float32) if track_m else None
    V = np.abs(rng.randn(depth, width, d)).astype(np.float32)
    bm = rng.randint(0, width, (depth, k)).astype(np.int32)
    bv = rng.randint(0, width, (depth, k)).astype(np.int32)
    sm = rng.choice([-1.0, 1.0], (depth, k)).astype(np.float32)
    g = rng.randn(k, d).astype(np.float32)
    kw = dict(lr=1e-2, b1=0.9 if track_m else 0.0, b2=0.999, eps=1e-8,
              bc1=0.19, bc2=0.002, n_valid=k - 3)
    want = _jax_whole_batch(
        None if M is None else jnp.asarray(M), jnp.asarray(V),
        jnp.asarray(bm), jnp.asarray(sm), jnp.asarray(bv), jnp.asarray(g),
        **kw)
    got = cs_adam_tiled(_t(M), _t(V), _t(bm) if track_m else None,
                        _t(sm) if track_m else None, _t(bv), _t(g), **kw)
    _close(want, got)
    assert cs_adam_tiled.launches == 0          # the CPU runs no kernel


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("track_m", [True, False])
def test_adam_fused_ref_matches_reference_scan(depth, track_m):
    """The per-item plain version against the reference's lax.scan, with
    colliding buckets; also the stream wrapper's CPU path."""
    width, d, k = 8, 32, 24
    rng = np.random.RandomState(depth + 2)
    M = rng.randn(depth, width, d).astype(np.float32) if track_m else None
    V = np.abs(rng.randn(depth, width, d)).astype(np.float32)
    bm = rng.randint(0, width, (depth, k)).astype(np.int32)
    bv = rng.randint(0, width, (depth, k)).astype(np.int32)
    sm = rng.choice([-1.0, 1.0], (depth, k)).astype(np.float32)
    g = rng.randn(k, d).astype(np.float32)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)
    mb = (bm, sm) if track_m else (None, None)
    want = jref.adam_fused_ref(
        *[None if a is None else jnp.asarray(a) for a in (M, V, *mb, bv, g)],
        **kw)
    for fn in (tref.adam_fused_ref, cs_adam_fused):
        got = fn(*[_t(a) for a in (M, V, *mb, bv, g)], **kw)
        _close(want, got)
    assert cs_adam_fused.launches == 0


@pytest.mark.parametrize("backend", ["ref", "xla", "stream", "tiled"])
def test_empty_batch_is_identity(backend):
    _, tspecs = _specs(128, 16, 3)
    M, V, _, _ = _inputs(tspecs[1], 1, 128, True, seed=0)
    ids = np.zeros((0,), np.int32)
    g = np.zeros((0, 16), np.float32)
    Mo, Vo, u = _run_torch(backend, tspecs, M, V, ids, g, 0.9)
    assert tuple(u.shape) == (0, 16)
    np.testing.assert_array_equal(Mo.numpy(), M)
    np.testing.assert_array_equal(Vo.numpy(), V)


def test_registry_and_auto_resolution():
    assert TK.backends() == ("ref", "xla", "stream", "tiled")
    assert TK.resolve_backend(None, torch.device("cpu")) == "xla"
    assert TK.resolve_backend("auto", torch.device("cuda")) == "tiled"
    assert TK.resolve_backend("stream") == "stream"
    with pytest.raises(KeyError):
        TK.resolve_backend("interpret")
    # the port keeps its own registry: the reference's is untouched
    from repro.kernels import registry as jreg
    assert JK.backends() == ("ref", "xla", "stream", "tiled", "interpret")
    assert jreg.resolve("pair", "adam_rows", None) == "xla"


def test_register_backend_lands_in_port_registry():
    from repro_torch.kernels import registry
    def probe(*args, **kwargs):
        return None

    TK.register_backend("_probe", probe)
    try:
        assert registry.lookup("pair", "adam_rows", "_probe") is probe
    finally:
        registry._REGISTRY[("pair", "adam_rows")].pop("_probe")
