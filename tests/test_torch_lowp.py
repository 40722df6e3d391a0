"""Parity of the port's bf16 and int8 sketch cells with the JAX reference.

The sketch ops (``query``/``update``/``decay``), the fused dense-path
``update_read`` on every port backend, the sparse-rows step, the async
cleaner and the ``convert`` hand-over run on the CPU against the
reference on the same numpy inputs.  The sketch ops have no fused
multiply-add to round differently, so they are held to the bit: cells
(bf16 bits, int8 codes and f32 scales) and f32 estimates.  The
optimizer trajectories go through the transforms' products and are held
to a tolerance (``TRAJ_TOL``), stated with its cause at the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
import repro_torch.kernels as TK
from repro.core import quantize as jqz
from repro.core import sketch as jcs
from repro.core import stores as jstores
from repro_torch import convert
from repro_torch.core import cleaning as tclean
from repro_torch.core import quantize as tqz
from repro_torch.core import sketch as tcs
from repro_torch.core import stores as tstores

LOWP = ["bfloat16", "int8"]
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)   # as tests/test_torch_dense.py
# ema_delta forms (beta, scale): Adam, Adagrad, momentum
FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
         "momentum": (0.9, 1.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread: torch 2.13's CPU build sometimes gets the first
    multithreaded ``sqrt`` of a process wrong (``test_torch_dense.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_t(state):
    """A reference sketch state (array or QuantState) as the port's."""
    return convert.tree_from_numpy(jax.device_get(state), "cpu")


def _assert_state_equal(jstate, tstate):
    """Bit-equal sketch states: bf16 bits, int8 codes and f32 scales."""
    want = convert.tree_to_numpy(_to_t(jstate))
    got = convert.tree_to_numpy(tstate)
    if isinstance(want, tqz.QuantState):
        assert isinstance(got, tqz.QuantState)
        np.testing.assert_array_equal(got.cells, want.cells)
        np.testing.assert_array_equal(got.scales, want.scales)
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint16) if got.dtype.itemsize
                                  == 2 else got, want.view(np.uint16)
                                  if want.dtype.itemsize == 2 else want)


def _cells(state) -> str:
    """The cell dtype name of a port sketch state."""
    if isinstance(state, tqz.QuantState):
        return "int8"
    return str(state.dtype).replace("torch.", "")


def _specs(dtype, signed, width=32, dim=8, depth=3, seed=9, identity=False,
           scale_block=16):
    kw = dict(depth=depth, width=width, dim=dim, signed=signed, seed=seed,
              identity=identity, scale_block=scale_block)
    return (jcs.SketchSpec(dtype=jnp.dtype(dtype), **kw),
            tcs.SketchSpec(dtype=dtype, **kw))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", LOWP + ["float32"])
@pytest.mark.parametrize("shape,kw", [
    ((151936, 896), {}), ((1000, 24), dict(width_multiple=16)),
    ((64, 8), dict(identity=True))])
def test_specs_build_and_nbytes_match(dtype, shape, kw):
    j = jcs.for_param(shape, dtype=jnp.dtype(dtype), **kw)
    t = tcs.for_param(shape, dtype=dtype, **kw)
    assert t.cell_dtype_name == j.cell_dtype_name == dtype
    assert t.quantized == j.quantized == (dtype == "int8")
    assert t.nbytes() == j.nbytes()
    init = tcs.init(t, "cpu")
    if dtype == "int8":
        assert init.cells.dtype == torch.int8
        assert init.cells.numel() + 4 * init.scales.numel() == t.nbytes()
    else:
        assert init.element_size() * init.numel() == t.nbytes()
    if shape == (151936, 896) and dtype == "bfloat16":
        assert t.nbytes() == 55_050_240       # f32: 110,100,480


def test_int8_cells_refuse_sharding():
    with pytest.raises(ValueError, match="sharding"):
        tcs.SketchSpec(depth=3, width=32, dim=4, dtype="int8", shards=2)


# ---------------------------------------------------------------------------
# query / update / decay
# ---------------------------------------------------------------------------

def _ids_delta(seed, k=64, hi=200, dim=8, signed=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, hi, k).astype(np.int32)       # collide, repeat
    delta = rng.randn(k, dim).astype(np.float32)
    if not signed:
        delta = np.abs(delta)
    return ids, delta


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("dtype", LOWP)
def test_update_query_decay_bit_equal(dtype, signed):
    """Two updates under different step seeds, a decay, a third update
    with the default seed; query after each.  Width 32 under 200 ids:
    buckets collide about 6 ids to one."""
    js, ts = _specs(dtype, signed)
    jS, tS = jcs.init(js), tcs.init(ts, "cpu")
    for i, sr in enumerate((tqz.step_seed(js.seed, 1),
                            tqz.step_seed(js.seed, 2), None)):
        ids, delta = _ids_delta(i, signed=signed)
        jS = jcs.update(js, jS, jnp.asarray(ids), jnp.asarray(delta),
                        sr_seed=None if sr is None else jnp.uint32(sr))
        tS = tcs.update(ts, tS, torch.from_numpy(ids),
                        torch.from_numpy(delta), sr_seed=sr)
        _assert_state_equal(jS, tS)
        q = np.random.RandomState(10 + i).randint(0, 200, 48).astype(np.int32)
        np.testing.assert_array_equal(
            tcs.query(ts, tS, torch.from_numpy(q)).numpy(),
            np.asarray(jcs.query(js, jS, jnp.asarray(q))))
        if i == 1:
            jS, tS = jcs.decay(jS, 0.3), tcs.decay(tS, 0.3)
            _assert_state_equal(jS, tS)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("dtype", LOWP)
def test_update_and_query_forms_bit_equal(dtype, signed):
    js, ts = _specs(dtype, signed, seed=4)
    ids, delta = _ids_delta(5, signed=signed)
    ids_t, delta_t = torch.from_numpy(ids), torch.from_numpy(delta)
    for jf, tf in ((jcs.update_and_query, tcs.update_and_query),
                   (jcs.query_after_update, tcs.query_after_update)):
        jS, jq = jf(js, jcs.init(js), jnp.asarray(ids), jnp.asarray(delta),
                    sr_seed=jnp.uint32(77))
        tS, tq = tf(ts, tcs.init(ts, "cpu"), ids_t, delta_t, sr_seed=77)
        _assert_state_equal(jS, tS)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_bf16_update_keeps_untouched_cells():
    """Untouched bf16 cells round to themselves (only -0 turns +0)."""
    _, ts = _specs("bfloat16", True, width=64)
    S = torch.randn(ts.shape).to(torch.bfloat16)
    before = S.clone()
    ids = torch.tensor([3], dtype=torch.int32)
    tcs.update(ts, S, ids, torch.ones((1, ts.dim)), sr_seed=5)
    b = ts.family.bucket(ids).long()[:, 0]
    keep = torch.ones(ts.shape[:2], dtype=torch.bool)
    keep[torch.arange(ts.depth), b] = False
    assert torch.equal(S[keep], before[keep])


def test_int8_decay_touches_only_scales():
    _, ts = _specs("int8", False)
    S = tcs.init(ts, "cpu")
    ids, delta = _ids_delta(1, signed=False)
    tcs.update(ts, S, torch.from_numpy(ids), torch.from_numpy(delta), 3)
    cells, scales = S.cells.clone(), S.scales.clone()
    tcs.decay(S, 0.2)
    assert torch.equal(S.cells, cells)
    assert torch.equal(S.scales, scales * 0.2)


def test_unsigned_int8_read_floor_matches_reference():
    """One huge row forces its block's scale up; tiny rows quantize to 0
    cells but read at least half a scale step, as in the reference
    (``tests/test_quantize.py::TestUnsignedReadFloor``)."""
    shape = (256, 4)
    js = jcs.for_param(shape, compression=2.0, signed=False, seed=5,
                       dtype=jnp.dtype("int8"), width_multiple=16)
    ts = tcs.for_param(shape, compression=2.0, signed=False, seed=5,
                       dtype="int8", width_multiple=16)
    g = np.full((128, 4), 1e-4, np.float32)
    g[0] = 100.0
    ids = np.arange(128, dtype=np.int32)
    jS = jcs.update(js, jcs.init(js), jnp.asarray(ids), jnp.asarray(g),
                    sr_seed=jnp.uint32(1))
    tS = tcs.update(ts, tcs.init(ts, "cpu"), torch.from_numpy(ids),
                    torch.from_numpy(g), sr_seed=1)
    _assert_state_equal(jS, tS)
    est = tcs.query(ts, tS, torch.from_numpy(ids))
    np.testing.assert_array_equal(est.numpy(),
                                  np.asarray(jcs.query(js, jS,
                                                       jnp.asarray(ids))))
    sc = tqz.bucket_scales(tS.scales, ts.family.bucket(torch.from_numpy(ids)),
                           ts.scale_block)
    assert bool((est.min(dim=1).values >= 0.5 * sc.min(dim=0).values).all())
    assert bool((sc > 0).all())
    # never-written blocks keep scale 0 and read exact zeros
    zero = tcs.query(ts, tcs.init(ts, "cpu"), torch.arange(8,
                                                           dtype=torch.int32))
    assert float(zero.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the batch sketch ops and update_read through the backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", LOWP)
def test_batch_sketch_ops_route_to_core(dtype):
    """``ops.sketch_update``/``sketch_query`` take lowp cells through
    ``core.sketch``, as the reference's do."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    js, ts = _specs(dtype, True)
    ids, delta = _ids_delta(2)
    jS = jops.sketch_update(js, jcs.init(js), jnp.asarray(ids),
                            jnp.asarray(delta))
    tS = tops.sketch_update(ts, tcs.init(ts, "cpu"), torch.from_numpy(ids),
                            torch.from_numpy(delta))
    _assert_state_equal(jS, tS)
    np.testing.assert_array_equal(
        tops.sketch_query(ts, tS, torch.from_numpy(ids)).numpy(),
        np.asarray(jops.sketch_query(js, jS, jnp.asarray(ids))))


KINDS = {"sketch": (jstores.CountSketchStore, tstores.CountSketchStore),
         "countmin": (jstores.CountMinStore, tstores.CountMinStore)}


def _stores(kind, dtype, n=384, d=8, identity=False, seed=0):
    jcls, tcls = KINDS[kind]
    kw = dict(compression=8.0, width_multiple=16, identity=identity,
              seed=seed, dtype=dtype)
    return (jcls(**kw).bind("tab", (n, d), jnp.float32),
            tcls(**kw).bind("tab", (n, d)))


def _state(spec, seed):
    """A non-trivial starting sketch of ``spec``'s cell dtype, made by the
    reference (two steps of its own update)."""
    rng = np.random.RandomState(seed)
    S = jcs.init(spec)
    for step in (1, 2):
        ids = rng.randint(0, 384, 96).astype(np.int32)
        delta = rng.randn(96, spec.dim).astype(np.float32)
        if not spec.signed:
            delta = np.abs(delta)
        S = jcs.update(spec, S, jnp.asarray(ids), jnp.asarray(delta),
                       sr_seed=jqz.step_seed(spec.seed, step))
    return S


@pytest.mark.parametrize("ours", ["ref", "xla", "tiled"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", LOWP)
def test_update_read_matches_reference_xla(dtype, kind, form, masked, ours):
    """The whole-table fused update_read (the dense path, rows=None) at
    step 7 on every port backend against the reference's ``xla``, bit
    for bit: buckets collide about 8 rows to one."""
    beta, scale = FORMS[form]
    js, ts = _stores(kind, dtype, seed=len(form))
    S0 = _state(js.spec, seed=len(form) + masked)
    rng = np.random.RandomState(3 + masked)
    x = rng.randn(384, 8).astype(np.float32)
    mask = (rng.rand(384, 1) > 0.3).astype(np.float32) if masked else None
    jS, jest = dataclasses.replace(js, backend="xla").update_read(
        S0, jnp.asarray(x), beta, scale=scale,
        mask=None if mask is None else jnp.asarray(mask), step=7)
    tS, test = dataclasses.replace(ts, backend=ours).update_read(
        _to_t(S0), torch.from_numpy(x), beta, scale=scale,
        mask=None if mask is None else torch.from_numpy(mask), step=7)
    _assert_state_equal(jS, tS)
    np.testing.assert_array_equal(test.numpy(), np.asarray(jest))


@pytest.mark.parametrize("dtype", LOWP)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_composed_update_read_on_rows_matches_reference(dtype, kind):
    """The composed form (no backend) on explicit rows, and ``strict``."""
    js, ts = _stores(kind, dtype, seed=2)
    S0 = _state(js.spec, seed=2)
    rng = np.random.RandomState(4)
    rows = rng.choice(384, 64, replace=False).astype(np.int32)
    x = np.abs(rng.randn(64, 8)).astype(np.float32)
    for strict in (False, True):
        jS, jest = js.update_read(S0, jnp.asarray(x), 0.9,
                                  rows=jnp.asarray(rows), strict=strict,
                                  step=3)
        tS, test = ts.update_read(_to_t(S0), torch.from_numpy(x), 0.9,
                                  rows=torch.from_numpy(rows), strict=strict,
                                  step=3)
        _assert_state_equal(jS, tS)
        np.testing.assert_array_equal(test.numpy(), np.asarray(jest))


@pytest.mark.parametrize("form,masked", [("adam", True), ("momentum", False),
                                         ("adagrad", True)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_tiled_matches_reference_kernel_collision_free(kind, form,
                                                            masked):
    """The reference's own B3 (Pallas, interpret mode) with its bf16
    branch, on an identity spec (every row its own bucket, so its
    streaming tiles equal whole-batch semantics), against the port's
    ``tiled``: the bf16 cells to the bit, as in
    ``tests/test_quantize.py``'s tiled-vs-xla check; ``est`` held at the
    reference's own atol 1e-6 there, since the Pallas body rounds
    ``ema_delta`` inside the tile."""
    beta, scale = FORMS[form]
    js, ts = _stores(kind, "bfloat16", n=64, identity=True)
    S0 = _state(js.spec, seed=6)
    rng = np.random.RandomState(7)
    x = rng.randn(64, 8).astype(np.float32)
    mask = (rng.rand(64, 1) > 0.3).astype(np.float32) if masked else None
    sr = jqz.step_seed(js.spec.seed, 5)
    rows = jnp.arange(64, dtype=jnp.int32)
    jS, jest = JK.update_read(js.spec, S0, rows, jnp.asarray(x), beta=beta,
                              scale=scale, backend="interpret",
                              mask=None if mask is None else jnp.asarray(mask),
                              sr_seed=sr)
    tS, test = TK.update_read(ts.spec, _to_t(S0), None, torch.from_numpy(x),
                              beta=beta, scale=scale, backend="tiled",
                              mask=None if mask is None
                              else torch.from_numpy(mask),
                              sr_seed=int(sr))
    _assert_state_equal(jS, tS)
    np.testing.assert_allclose(test.numpy(), np.asarray(jest), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dtype", LOWP)
@pytest.mark.parametrize("backend", ["ref", "xla", "stream", "tiled"])
def test_sparse_rows_step_runs_xla_for_lowp_cells(dtype, backend):
    """Every sparse-rows backend runs the whole-batch ``xla`` form for
    bf16/int8 cells, with the step's rounding seeds: the port's against
    the reference's ``xla``, three steps of duplicate-heavy ids."""
    from repro_torch.kernels import cs_adam, cs_adam_tiled
    n, d = 512, 8
    sm_j = jcs.for_param((n, d), signed=True, seed=11, dtype=jnp.dtype(dtype),
                         width_multiple=16, compression=4.0)
    sv_j = jcs.for_param((n, d), signed=False, seed=23,
                         dtype=jnp.dtype(dtype), width_multiple=16,
                         compression=4.0)
    sm_t = tcs.for_param((n, d), signed=True, seed=11, dtype=dtype,
                         width_multiple=16, compression=4.0)
    sv_t = tcs.for_param((n, d), signed=False, seed=23, dtype=dtype,
                         width_multiple=16, compression=4.0)
    jM, jV = jcs.init(sm_j), jcs.init(sv_j)
    tM, tV = tcs.init(sm_t, "cpu"), tcs.init(sv_t, "cpu")
    before = (cs_adam.cs_adam_fused.launches,
              cs_adam_tiled.cs_adam_tiled.launches)
    rng = np.random.RandomState(0)
    for step in (1, 2, 3):
        ids = (rng.zipf(1.3, 96) % n).astype(np.int32)
        g = rng.randn(96, d).astype(np.float32)
        jM, jV, jupd = JK.adam_rows(sm_j, sv_j, jM, jV, jnp.asarray(ids),
                                    jnp.asarray(g), jnp.asarray(step),
                                    lr=3e-3, backend="xla")
        tM, tV, tupd = TK.adam_rows(sm_t, sv_t, tM, tV, torch.from_numpy(ids),
                                    torch.from_numpy(g),
                                    torch.tensor(step, dtype=torch.int32),
                                    lr=3e-3, backend=backend)
        _assert_state_equal(jM, tM)
        _assert_state_equal(jV, tV)
        # the direction goes through sqrt and a division: one ulp of
        # torch's CPU sqrt (ROADMAP), no more
        np.testing.assert_allclose(tupd.numpy(), np.asarray(jupd),
                                   rtol=1e-5, atol=1e-6)
    assert (cs_adam.cs_adam_fused.launches,
            cs_adam_tiled.cs_adam_tiled.launches) == before


# ---------------------------------------------------------------------------
# long horizons
# ---------------------------------------------------------------------------

def _ema_drift(beta: float, dtype: str, steps: int = 400) -> float:
    """Rel-L1 of a long low-precision EMA against an f32 one on the same
    stream through the port's ``xla`` update_read (the reference's
    ``tests/test_quantize.py::_ema_drift``)."""
    n, d = 512, 8
    specs = {dt: tcs.for_param((n, d), compression=4.0, signed=False,
                               seed=13, dtype=dt, width_multiple=16)
             for dt in ("float32", dtype)}
    states = {dt: tcs.init(sp, "cpu") for dt, sp in specs.items()}
    rng = np.random.RandomState(0)
    for t in range(steps):
        ids = torch.from_numpy(rng.randint(0, n, size=64).astype(np.int32))
        g = torch.from_numpy((rng.randn(64, d) ** 2).astype(np.float32))
        for dt, sp in specs.items():
            sr = tqz.step_seed(sp.seed, t + 1) if sp.lowp else None
            states[dt], _ = TK.update_read(sp, states[dt], ids, g, beta=beta,
                                           scale=1.0 - beta, backend="xla",
                                           sr_seed=sr)
    rows = torch.arange(n, dtype=torch.int32)
    ref = tcs.query(specs["float32"], states["float32"], rows)
    est = tcs.query(specs[dtype], states[dtype], rows)
    return float((est - ref).abs().sum() / (ref.abs().sum() + 1e-12))


DRIFT_BOUND = {"bfloat16": 0.02, "int8": 0.35}


@pytest.mark.parametrize("beta", [0.9, 0.999])
@pytest.mark.parametrize("dtype", LOWP)
def test_ema_drift_bounded(beta, dtype):
    """The reference's drift property (``tests/test_quantize.py:256-271``)
    on the port: 400 steps stay within bf16 2 %, int8 35 %."""
    assert _ema_drift(beta, dtype) < DRIFT_BOUND[dtype]


def _softmax_run(pkg, dtype, steps=30, v=1024, d=32, t=64, lr=3e-3):
    """``steps`` of ``countsketch_adam`` (bf16 or int8 sketches, backend
    xla on the reference, auto on the port) on a softmax layer with a full
    softmax; returns the per-step losses and the table."""
    rng = np.random.RandomState(0)
    teacher = rng.randn(v, d).astype(np.float32)
    table0 = (rng.randn(v, d) / np.sqrt(d)).astype(np.float32)
    ys = [((rng.zipf(1.1, t) - 1) % v).astype(np.int32) for _ in range(steps)]
    noise = [rng.randn(t, d).astype(np.float32) for _ in range(steps)]
    if pkg == "jax":
        from repro.core import optimizers as JO
        from repro.core.partition import SketchPolicy
        opt = JO.countsketch_adam(lr, policy=SketchPolicy(),
                                  hparams=JO.SketchHParams(
                                      backend="xla", dtype=dtype,
                                      width_multiple=16))

        def loss_fn(p, y, n):
            h = jnp.asarray(teacher)[y] + n
            logp = jax.nn.log_softmax(h @ p["tok_embed"]["table"].T)
            return -jnp.mean(logp[jnp.arange(t), y])
        p = {"tok_embed": {"table": jnp.asarray(table0)}}
        st, losses = opt.init(p), []
        for y, n in zip(ys, noise):
            loss, g = jax.value_and_grad(loss_fn)(p, jnp.asarray(y),
                                                  jnp.asarray(n))
            u, st = opt.update(g, st, p)
            p = JO.apply_updates(p, u)
            losses.append(float(loss))
        return losses, np.asarray(p["tok_embed"]["table"])
    from repro_torch.core import optimizers as TO
    from repro_torch.core.partition import SketchPolicy
    opt = TO.countsketch_adam(lr, policy=SketchPolicy(),
                              hparams=TO.SketchHParams(
                                  backend="auto", dtype=dtype,
                                  width_multiple=16))
    table = torch.from_numpy(table0.copy()).requires_grad_()
    p = {"tok_embed": {"table": table}}
    st, losses = opt.init(p), []
    assert _cells(st["v"]["tok_embed"]["table"]) == dtype
    for y, n in zip(ys, noise):
        y = torch.from_numpy(y).long()
        h = torch.from_numpy(teacher)[y] + torch.from_numpy(n)
        loss = torch.nn.functional.cross_entropy(h @ table.t(), y)
        (g,) = torch.autograd.grad(loss, [table])
        u, st = opt.update({"tok_embed": {"table": g}}, st)
        TO.apply_updates(p, u)
        losses.append(float(loss.detach()))
    return losses, table.detach().numpy()


@pytest.mark.parametrize("dtype", LOWP)
def test_optimizer_trajectory_keeps_sketches_bit_exact(dtype):
    """30 steps of ``countsketch_adam`` with bf16 or int8 sketches on a
    (1024, 32) table fed the same numpy gradients (a third of the rows
    zero, so the lazy mask matters): the reference's ``xla`` and the
    port's ``auto`` (xla on the CPU) keep the sketches equal to the bit
    at every step.  The table takes ``-lr·m̂/(√v̂+ε)``, whose ``sqrt``
    and divisions round apart in the last ulp (ROADMAP), so it is held
    to ``TRAJ_TOL`` (measured: 4.8e-7 after 30 steps)."""
    from repro.core import optimizers as JO
    from repro.core.partition import SketchPolicy as JP
    from repro_torch.core import optimizers as TO
    from repro_torch.core.partition import SketchPolicy as TP
    v, d, lr = 1024, 32, 3e-3
    rng = np.random.RandomState(0)
    table0 = (rng.randn(v, d) / np.sqrt(d)).astype(np.float32)
    hp = dict(dtype=dtype, width_multiple=16)
    jopt = JO.countsketch_adam(lr, policy=JP(),
                               hparams=JO.SketchHParams(backend="xla", **hp))
    topt = TO.countsketch_adam(lr, policy=TP(),
                               hparams=TO.SketchHParams(backend="auto", **hp))
    jp = {"tok_embed": {"table": jnp.asarray(table0)}}
    tp = {"tok_embed": {"table": torch.from_numpy(table0.copy())}}
    js, ts = jopt.init(jp), topt.init(tp)
    assert _cells(ts["m"]["tok_embed"]["table"]) == dtype
    for _ in range(30):
        g = (rng.randn(v, d) * 0.01).astype(np.float32)
        g[rng.rand(v) < 0.3] = 0.0
        u, js = jopt.update({"tok_embed": {"table": jnp.asarray(g)}}, js, jp)
        jp = JO.apply_updates(jp, u)
        u, ts = topt.update({"tok_embed": {"table": torch.from_numpy(g)}}, ts)
        TO.apply_updates(tp, u)
        for part in ("m", "v"):
            _assert_state_equal(js[part]["tok_embed"]["table"],
                                ts[part]["tok_embed"]["table"])
    np.testing.assert_allclose(tp["tok_embed"]["table"].numpy(),
                               np.asarray(jp["tok_embed"]["table"]),
                               **TRAJ_TOL)


@pytest.mark.parametrize("dtype", LOWP)
def test_softmax_trajectory_matches_reference(dtype):
    """30 steps of ``countsketch_adam`` with bf16 or int8 sketches on a
    (1024, 32) softmax layer (full softmax: every row has a gradient),
    each package taking its own gradients (``jax.grad`` against
    autograd).  Those differ in the last ulp (XLA fuses the log-softmax
    and matmul differently), so a stochastic rounding whose value lies
    within an ulp of its cut goes the other way, moving a bf16 cell by
    2**-8 of itself or an int8 cell by a scale step.  The losses and the
    table are held at bf16's resolution, rtol 1e-3, atol 1e-4 (measured:
    losses within 5.7e-7 relative; the table within 1.4e-4 at bf16, from
    flipped roundings, and 8.5e-7 at int8)."""
    jl, jp = _softmax_run("jax", dtype)
    tl, tp = _softmax_run("torch", dtype)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tp, jp, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# cleaning and the state hand-over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32"] + LOWP)
def test_async_cleaning_equals_sync(dtype):
    """Ten steps of the dense path with a Count-Min cleaned every 5
    steps: the ``AsyncCleaner`` (decay between steps) gives the sync
    schedule's sketches and table to the bit, and the sync run matches
    the reference's sync run."""
    from repro_torch.core import optimizers as TO
    n, d = 256, 8

    def run(mode):
        sched = tclean.CleaningSchedule(alpha=0.5, every=5, mode=mode)
        cm = tstores.CountMinStore(compression=4.0, width_multiple=16,
                                   dtype=dtype, cleaning=sched,
                                   backend="auto")
        cs_ = tstores.CountSketchStore(compression=4.0, width_multiple=16,
                                       dtype=dtype, backend="auto")
        tree = tstores.StoreTree(rules=(("w", cs_, cm),))
        opt = TO.adam_from_stores(1e-2, tree)
        rng = np.random.RandomState(0)
        p = {"w": torch.from_numpy(rng.randn(n, d).astype(np.float32))}
        st = opt.init(p)
        cleaner = tclean.AsyncCleaner(sched, getter=lambda s: s["v"]) \
            if mode == "async" else None
        fired = 0
        for step in range(1, 11):
            if cleaner is not None:
                st, f = cleaner.maybe_dispatch(st, step)
                fired += f
                assert not cleaner.in_flight()
            g = torch.from_numpy(rng.randn(n, d).astype(np.float32))
            u, st = opt.update({"w": g}, st)
            TO.apply_updates(p, u)
        if cleaner is not None:
            assert fired == cleaner.dispatched == 2
        return p, st

    ps, ss = run("sync")
    pa, sa = run("async")
    assert torch.equal(ps["w"], pa["w"])
    for a, b in zip(jax.tree_util.tree_leaves(convert.tree_to_numpy(ss)),
                    jax.tree_util.tree_leaves(convert.tree_to_numpy(sa))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_schedule_hook_is_a_no_op():
    sched = tclean.CleaningSchedule(alpha=0.5, every=2, mode="async")
    S = torch.ones((3, 4, 2))
    assert torch.equal(tclean.maybe_clean(sched, S, 2), torch.ones((3, 4, 2)))
    with pytest.raises(ValueError):
        tclean.CleaningSchedule(mode="later")
    with pytest.raises(ValueError):
        tclean.AsyncCleaner(tclean.CleaningSchedule(mode="sync"))


@pytest.mark.parametrize("dtype", LOWP)
def test_sync_cleaning_matches_reference(dtype):
    """The reference's sync clean of a low-precision Count-Min (bf16:
    times bf16(alpha); int8: the scales only) against the port's."""
    from repro.core.cleaning import CleaningSchedule as JSched
    js, ts = _stores("countmin", dtype, seed=1)
    js = dataclasses.replace(js, cleaning=JSched(alpha=0.3, every=4))
    ts = dataclasses.replace(ts, cleaning=tclean.CleaningSchedule(alpha=0.3,
                                                                  every=4))
    S0 = _state(js.spec, seed=1)
    for step in (3, 4):
        jS = js.clean(S0, jnp.asarray(step))
        tS = ts.clean(_to_t(S0), torch.tensor(step, dtype=torch.int32))
        _assert_state_equal(jS, tS)


@pytest.mark.parametrize("dtype", LOWP)
def test_convert_round_trips_low_precision_state(dtype):
    """A JAX optimizer state with bf16 or int8 sketches crosses into the
    port and back bit for bit, step counter included."""
    from repro.core import optimizers as JO
    from repro.core.partition import SketchPolicy
    opt = JO.countsketch_adam(1e-2, policy=SketchPolicy(),
                              hparams=JO.SketchHParams(
                                  backend="xla", dtype=dtype,
                                  width_multiple=16))
    rng = np.random.RandomState(0)
    p = {"tok_embed": {"table": jnp.asarray(rng.randn(1024, 8),
                                            jnp.float32)},
         "w": jnp.asarray(rng.randn(4, 4), jnp.float32)}
    st = opt.init(p)
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape), jnp.float32), p)
        _, st = opt.update(g, st, p)
    host = jax.device_get(st)
    t = convert.tree_from_numpy(host, "cpu")
    m = t["m"]["tok_embed"]["table"]
    if dtype == "int8":
        assert isinstance(m, tqz.QuantState) and m.cells.dtype == torch.int8
    else:
        assert m.dtype == torch.bfloat16
    assert t["m"]["w"].dtype == torch.float32 and int(t["step"]) == 2
    back = convert.tree_to_numpy(t)
    want = jax.tree_util.tree_leaves(host)
    got = jax.tree_util.tree_leaves(back)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.atleast_1d(b).view(np.uint8),
                                      np.atleast_1d(a).view(np.uint8))
