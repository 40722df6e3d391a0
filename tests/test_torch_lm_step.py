"""``repro_torch.train.steps.make_train_step`` against the JAX package's
on the CPU: every ``build_optimizer`` mode, 3 steps from one converted
start on the same batches, with the kernel backend None (the composed
dense path) and ``xla`` (the fused plain route of the sketched leaves).
Tolerance: rtol 1e-4 / atol 1e-5, the ROADMAP's envelope after a
trajectory.  The config is qwen2-0.5b's ``reduced()`` in f32 compute;
the sketched modes run it with ``vocab_size=2048``, since at 512 rows no
table clears ``SketchPolicy``'s ``min_rows=1024`` and every sketched
mode would be its dense form (one ``cs_adam`` case keeps the plain
``reduced()``).

Each trajectory is held twice:

* each package on its own gradients (``step_fn`` as users call it): the
  per-step loss and grad norm and every optimizer-state leaf.  The
  params are not held element by element here: XLA and torch order the
  gradient's sums differently, and Adam's ``g / (|g| + eps)`` turns the
  last bits of a gradient within a few eps of zero into a different
  step (measured: one ``w_gate`` element 3.1e-5 apart after step 1 of
  ``dense_adam`` from the same start), as do the sketched tables' rows
  whose cells cancel (1.2e-3 by step 3 of ``cs_adam``);
* the port's ``step_fn`` fed the reference's gradient at each step
  (``torch.autograd.grad`` answered with the JAX gradient of the same
  params and batch) against the reference's step split at the same
  point: every param and state leaf after every step.  With the model's
  gradients held in ``test_torch_models.py``, this holds all of the
  step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import optimizers as topt
from repro_torch.core.partition import leaf_paths
from repro_torch.train import steps as TS

CPU = torch.device("cpu")
TRAJ = dict(rtol=1e-4, atol=1e-5)
SKETCHED = ("cs_adam", "cs_adam_v", "cs_rmsprop", "cs_adagrad",
            "cs_momentum", "lr_nmf_adam")
DENSE = ("dense_adam", "dense_adagrad", "dense_momentum")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(vocab, n=3, b=2, s=32):
    rs = np.random.RandomState(7)
    out = []
    for _ in range(n):
        tok = rs.randint(1, vocab, (b, s)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out


def _flat(tree):
    """{path: f32 numpy} of a params or state tree of either package."""
    if any(isinstance(x, torch.Tensor) for _, x in leaf_paths(tree)):
        tree = convert.tree_to_numpy(tree)
    return {p: np.asarray(x, np.float32) for p, x in leaf_paths(tree)}


def _assert_trees_close(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for path in w:
        np.testing.assert_allclose(g[path], w[path], **TRAJ,
                                   err_msg=f"{what}: {path}")


def _jax_step_parts(jts, cfg):
    """The reference's ``make_train_step`` body split at the gradient:
    (grad_fn, update_fn), as its ``step_body`` composes them."""
    from repro.core import optimizers as jopt
    from repro.models import transformer as JT
    clip = jopt.clip_by_global_norm(1.0)

    def grad_fn(params, batch):
        return jax.value_and_grad(
            lambda p: JT.train_loss(cfg, p, batch))(params)

    def update_fn(params, state, grads):
        grads = clip(grads)
        updates, state = jts.optimizer.update(grads, state, params)
        return jopt.apply_updates(params, updates), state

    return jax.jit(grad_fn), jax.jit(update_fn)


def run_on_reference_grads(jts, tts, cfg_j, seed, monkeypatch, what):
    grad_fn, update_fn = _jax_step_parts(jts, cfg_j)
    params = jts.init_fn(jax.random.PRNGKey(seed))
    state = jts.optimizer.init(params)
    tp = convert.tree_from_numpy(jax.device_get(params), CPU)
    tstate = convert.tree_from_numpy(jax.device_get(state), CPU)
    for batch in _batches(cfg_j.vocab):
        _loss, jg = grad_fn(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        ref = dict(leaf_paths(jax.device_get(jg)))
        order = [p for p, _ in leaf_paths(tp)]
        monkeypatch.setattr(torch.autograd, "grad", lambda loss, xs: tuple(
            torch.from_numpy(np.array(ref[p])) for p in order))
        tp, tstate, _ = tts.step_fn(
            tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        monkeypatch.undo()
        params, state = update_fn(params, state, jg)
        _assert_trees_close(tp, jax.device_get(params), f"{what} params")
        _assert_trees_close(tstate, jax.device_get(state),
                            f"{what} opt state")
    return tstate


def run_pair(mode, backend, **over):
    cfg_j = jconfigs.get("qwen2_0_5b").reduced(**over)
    cfg_t = tconfigs.get("qwen2_0_5b").reduced(**over)
    jts = JS.make_train_step(cfg_j, optimizer=mode, kernel_backend=backend)
    params = jts.init_fn(jax.random.PRNGKey(0))
    state = jts.optimizer.init(params)
    p0, s0 = jax.device_get(params), jax.device_get(state)
    tts = TS.make_train_step(cfg_t, optimizer=mode, kernel_backend=backend,
                             device=CPU)
    tp = convert.tree_from_numpy(p0, CPU)
    tstate = convert.tree_from_numpy(s0, CPU)
    jstep = jax.jit(jts.step_fn)
    jm, tm = [], []
    for batch in _batches(cfg_j.vocab):
        params, state, m = jstep(params, state,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tp, tstate, m2 = tts.step_fn(
            tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        tm.append({k: float(v) for k, v in m2.items()})
    return (jm, jax.device_get(params), jax.device_get(state)), \
        (tm, tp, tstate), tts


def _check(mode, backend, monkeypatch, **over):
    (jm, jp, js), (tm, tp, ts), tts = run_pair(mode, backend, **over)
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys() == {"loss", "grad_norm"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TRAJ)
    _assert_trees_close(ts, js, f"{mode}/{backend} opt state")
    assert int(ts["step"]) == 3
    assert sorted(_flat(tp)) == sorted(_flat(jp))
    cfg_j = jconfigs.get("qwen2_0_5b").reduced(**over)
    run_on_reference_grads(
        JS.make_train_step(cfg_j, optimizer=mode, kernel_backend=backend),
        tts, cfg_j, 0, monkeypatch, f"{mode}/{backend}")
    return tts, ts


@pytest.mark.parametrize("backend", [None, "xla"])
@pytest.mark.parametrize("mode", SKETCHED)
def test_sketched_modes_match_reference(mode, backend, monkeypatch):
    tts, state = _check(mode, backend, monkeypatch, vocab_size=2048)
    if mode != "lr_nmf_adam":
        # the vocabulary tables really are sketched: state smaller than
        # the table
        kind = "v" if mode not in ("cs_momentum",) else "m"
        leaf = dict(leaf_paths(state[kind]))
        assert leaf["lm_head/table"].numel() < 2048 * 128
        assert leaf["tok_embed/table"].numel() < 2048 * 128


@pytest.mark.parametrize("backend", [None, "xla"])
@pytest.mark.parametrize("mode", DENSE)
def test_dense_modes_match_reference(mode, backend, monkeypatch):
    _check(mode, backend, monkeypatch, vocab_size=2048)


@pytest.mark.parametrize("backend", [None, "xla"])
def test_cs_adam_at_plain_reduced_matches_reference(backend, monkeypatch):
    _check("cs_adam", backend, monkeypatch)


def test_planned_step_matches_reference(monkeypatch):
    """``make_train_step(plan=)``: the reference's plan of the same
    config and budget, executed in both packages."""
    from repro.plan import plan_for_config as jplan
    from repro_torch.plan import Plan
    cfg_j = jconfigs.get("qwen2_0_5b").reduced(vocab_size=4096)
    cfg_t = tconfigs.get("qwen2_0_5b").reduced(vocab_size=4096)
    pj = jplan(cfg_j, "floor")
    pt = Plan.from_json(pj.to_json())
    from repro_torch.plan import plan_for_config as tplan
    assert tplan(cfg_t, "floor").to_json() == pj.to_json()
    jts = JS.make_train_step(cfg_j, optimizer="cs_adam", plan=pj,
                             kernel_backend="xla")
    tts = TS.make_train_step(cfg_t, optimizer="cs_adam", plan=pt,
                             kernel_backend="xla", device=CPU)
    params = jts.init_fn(jax.random.PRNGKey(1))
    state = jts.optimizer.init(params)
    tp = convert.tree_from_numpy(jax.device_get(params), CPU)
    ts = convert.tree_from_numpy(jax.device_get(state), CPU)
    from repro_torch.plan import measure_aux_bytes
    assert measure_aux_bytes(ts) == pt.predicted_aux_bytes
    jstep = jax.jit(jts.step_fn)
    for batch in _batches(cfg_j.vocab):
        params, state, jm = jstep(params, state, {k: jnp.asarray(v)
                                                  for k, v in batch.items()})
        tp, ts, tm = tts.step_fn(tp, ts, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TRAJ)
    _assert_trees_close(ts, jax.device_get(state), "planned state")
    assert tts.store_tree == pt.store_tree()
    run_on_reference_grads(jts, tts, cfg_j, 1, monkeypatch, "planned")


def test_shapes_allocate_nothing_and_match_reference():
    cfg_j = jconfigs.get("qwen2_0_5b")
    cfg_t = tconfigs.get("qwen2_0_5b")
    tts = TS.make_train_step(cfg_t, optimizer="cs_adam", device=CPU)
    ps = tts.params_shape()
    os_ = tts.opt_shape(ps)
    assert all(x.device.type == "meta" for _, x in leaf_paths(ps))
    jts = JS.make_train_step(cfg_j, optimizer="cs_adam")
    jos = jts.opt_shape()
    jbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                 for x in jax.tree_util.tree_leaves(jos)
                 if x.shape != ())
    tbytes = sum(x.numel() * x.element_size() for _, x in leaf_paths(os_)
                 if x.dim() > 0)
    assert tbytes == jbytes == 3_303_586_816
    dts = TS.make_train_step(cfg_t, optimizer="dense_adam", device=CPU)
    from repro_torch.plan import measure_aux_bytes
    assert measure_aux_bytes(dts.opt_shape()) == 5_041_339_392
    # state_bytes also counts the int32 step counter
    assert topt.state_bytes(dts.opt_shape()) == 5_041_339_392 + 4


def test_unported_arguments_raise():
    cfg = tconfigs.get("qwen2_0_5b").reduced()
    # dp_axis is ported (tests/test_torch_dp.py)
    assert TS.make_train_step(cfg, dp_axis="data", device=CPU).dp_axis \
        == "data"
    ts = TS.make_train_step(cfg, device=CPU)
    # placement is ported (tests/test_torch_sharding.py): spec trees
    from repro_torch.distributed.sharding import Grid
    pspec, ospec, bspec, mspec = ts.shardings(
        Grid((2, 4)), {"tokens": np.zeros((8, 16), np.int32)})
    assert bspec == {"tokens": ("data",)} and mspec == ()
    assert pspec["final_norm"] == ()
    assert type(ospec) is type(ts.opt_shape())
    with pytest.raises(ValueError, match="unknown optimizer"):
        TS.build_optimizer(cfg, "sgd")
    from repro_torch.plan import plan_for_config
    plan = plan_for_config(cfg.reduced(vocab_size=4096), "floor")
    with pytest.raises(ValueError, match="memory plan"):
        TS.build_optimizer(cfg, "dense_adam", plan=plan)
