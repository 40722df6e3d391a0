"""Helpers shared by the port's model-family parity tests
(``test_torch_encdec.py``, ``test_torch_vlm.py``, ``test_torch_rwkv.py``,
``test_torch_hybrid.py``): one start carried
from the JAX package to the port, the train step run in both on the
same numpy batches, the entry points' outputs side by side.

Tolerances are the ROADMAP's: ``OP`` for one op, ``MODEL`` for model
outputs and trajectories (f32 compute at ``reduced()``); ``BF16_LOSS``
and ``BF16_SCALE`` for bf16 compute.
"""
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.partition import leaf_paths

CPU = torch.device("cpu")
OP = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
# bf16 compute (the rwkv6 and hybrid tests): the port rounds each op's
# output to bf16, where XLA's CPU fusions keep some intermediates in f32
# (excess precision): the loss within 1e-3 relative, logits and state
# leaves within 2^-4 of the largest magnitude (of the row for logits, of
# the leaf for the state).  Measured over seeds 0-3 of both families:
# loss 1.7e-4, logits 6.8 bf16 ulps (2^-8 each) of the row's largest
# |logit|.
BF16_LOSS = dict(rtol=1e-3, atol=0)
BF16_SCALE = 2.0 ** -4
LOSS = re.compile(r"loss (\S+) -> (\S+)")


def t(a) -> torch.Tensor:
    """A torch copy of a numpy or JAX array (never the array's buffer)."""
    return torch.from_numpy(np.array(a))


def close(got, want, tol=MODEL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def within_scale(got, want, frac: float, axis=None):
    """|got - want| <= frac x the largest |want| (along ``axis``: of each
    row), both as f32."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max(axis=axis, keepdims=axis is not None)
    worst = float((np.abs(np.asarray(got, np.float32) - want)
                   / scale).max())
    assert worst <= frac, f"{worst} of the largest magnitude > {frac}"


def flat(tree) -> dict:
    """{path: f32 numpy} of a params or state tree of either package."""
    if any(isinstance(x, torch.Tensor) for _, x in leaf_paths(tree)):
        tree = convert.tree_to_numpy(tree)
    return {p: np.asarray(x, np.float32) for p, x in leaf_paths(tree)}


def trees_close(got, want, what, tol=MODEL):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), what
    for path in w:
        close(g[path], w[path], tol, f"{what}: {path}")


def shapes(tree) -> dict:
    """{path: shape} of a JAX (or eval_shape) tree or a port tree."""
    if any(isinstance(x, torch.Tensor) for _, x in leaf_paths(tree)):
        return {p: tuple(x.shape) for p, x in leaf_paths(tree)}
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_match(jmod, tmod, cfg_j, cfg_t, pj, batch, remat: bool, **kw):
    """``train_loss`` and every gradient leaf of both packages on one
    start and one batch (numpy), within MODEL; returns the port's
    gradient tree as {path: tensor}."""
    jl, jg = jax.value_and_grad(
        lambda p: jmod.train_loss(cfg_j, p, batch, remat=remat, **kw))(pj)
    live = convert.tree_from_numpy(pj, CPU)
    for _p, x in leaf_paths(live):
        x.requires_grad_(True)
    tl = tmod.train_loss(cfg_t, live, {k: t(v) for k, v in batch.items()},
                         remat=remat, **kw)
    tl.backward()
    close(tl, jl)
    jgrads = dict(leaf_paths(jax.device_get(jg)))
    tpaths = leaf_paths(live)
    assert sorted(p for p, _ in tpaths) == sorted(jgrads)
    for path, x in tpaths:
        close(x.grad, jgrads[path], MODEL, path)
    return {p: x.grad for p, x in tpaths}


def trajectory(jmod, JS, TS, cfg_j, cfg_t, batches, monkeypatch, *,
               mode="cs_adam", backend="xla", own_steps=3):
    """``make_train_step`` of both packages from one converted start.
    First ``own_steps`` steps on each package's own gradients: per-step
    loss and grad norm and the optimizer state within MODEL.  Then every
    batch again from the start, the port's ``step_fn`` answered with the
    reference's gradient of the same params (``torch.autograd.grad``
    patched) against the reference's step split at the same point: every
    param and state leaf after every step within MODEL.  Returns the
    port's final state."""
    from repro.core import optimizers as jopt
    jts = JS.make_train_step(cfg_j, optimizer=mode, kernel_backend=backend)
    tts = TS.make_train_step(cfg_t, optimizer=mode, kernel_backend=backend,
                             device=CPU)
    params = jts.init_fn(jax.random.PRNGKey(0))
    state = jts.optimizer.init(params)
    p0, s0 = jax.device_get(params), jax.device_get(state)

    jstep = jax.jit(jts.step_fn)
    tp = convert.tree_from_numpy(p0, CPU)
    ts = convert.tree_from_numpy(s0, CPU)
    for batch in batches[:own_steps]:
        params, state, jm = jstep(params, state, batch)
        tp, ts, tm = port_step(tts, tp, ts, batch)
        for k in ("loss", "grad_norm"):
            close(float(tm[k]), float(jm[k]), MODEL, k)
    trees_close(ts, jax.device_get(state), f"{mode} state, own gradients")

    clip = jopt.clip_by_global_norm(1.0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.train_loss(cfg_j, p, b)))

    def update(params, state, grads):
        updates, state = jts.optimizer.update(clip(grads), state, params)
        return jopt.apply_updates(params, updates), state
    update = jax.jit(update)

    params, state = p0, s0
    tp = convert.tree_from_numpy(p0, CPU)
    ts = convert.tree_from_numpy(s0, CPU)
    order = [p for p, _ in leaf_paths(tp)]
    for i, batch in enumerate(batches):
        _loss, jg = grad_fn(params, batch)
        ref = dict(leaf_paths(jax.device_get(jg)))
        monkeypatch.setattr(torch.autograd, "grad", lambda loss, xs: tuple(
            t(ref[p]) for p in order))
        tp, ts, _ = port_step(tts, tp, ts, batch)
        monkeypatch.undo()
        params, state = update(params, state, jg)
        trees_close(tp, jax.device_get(params), f"{mode} params, step {i}")
        trees_close(ts, jax.device_get(state), f"{mode} state, step {i}")
    return ts


def port_step(tts, tp, ts, batch):
    return tts.step_fn(tp, ts, {k: t(v) for k, v in batch.items()})


# ------------------------------------------------------------ placement
def mesh(shape, names):
    """A device-free mesh both packages' spec rules read."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


def jax_specs_flat(specs) -> dict:
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding as J
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)
    return {"/".join(J._kp_str(kp)): None if s is None else tuple(s)
            for kp, s in leaves}


def port_specs_flat(specs, like) -> dict:
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.distributed import sharding as T
    return {p: None if s is None else tuple(s) for (p, _), s in
            zip(_flatten(like), T._spec_leaves(specs, like))}


def serve_specs(monkeypatch, cfg_j, cfg_t, m, batch=16, max_seq=256):
    """(reference, port) flattened cache and param specs of
    ``make_serve_step`` on the device-free mesh ``m``."""
    import repro.serve.steps as JSS
    from repro.distributed import sharding as J
    from repro_torch.serve import steps as TSS
    monkeypatch.setattr(J, "named", lambda mesh, tree: tree)
    js = JSS.make_serve_step(cfg_j, batch=batch, max_seq=max_seq)
    ts = TSS.make_serve_step(cfg_t, batch=batch, max_seq=max_seq)
    want = (jax_specs_flat(js.cache_specs(m)),
            jax_specs_flat(js.param_shardings(m)))
    got = (port_specs_flat(ts.cache_specs(m), ts.cache_shape()),
           port_specs_flat(ts.param_shardings(m), ts.params_shape()))
    return want, got


# ------------------------------------------------------------- launchers
def jax_main(monkeypatch, capsys, args):
    from repro.launch import train as JL
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + args)
    capsys.readouterr()
    assert JL.main() == 0
    return capsys.readouterr().out


def port_main(capsys, args):
    from repro_torch.launch import train as TL
    capsys.readouterr()
    assert TL.main(args + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def loss_line(out):
    line = [l for l in out.splitlines() if l.startswith("[train]")][-1]
    return line, tuple(float(x) for x in LOSS.search(line).groups())


def launcher_lines(tmp_path, monkeypatch, capsys, base, steps=3):
    """The ``[train]`` lines of both launchers resuming the JAX
    launcher's step-0 checkpoint for ``steps`` steps."""
    import shutil
    from repro_torch.checkpoint import store
    jax_main(monkeypatch, capsys, base + ["--steps", "0", "--ckpt-dir",
                                          str(tmp_path / "j")])
    assert store.latest_step(tmp_path / "j") == 0
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jline = loss_line(jax_main(monkeypatch, capsys, base + [
        "--steps", str(steps), "--ckpt-dir", str(tmp_path / "j")]))
    tline = loss_line(port_main(capsys, base + [
        "--steps", str(steps), "--ckpt-dir", str(tmp_path / "t")]))
    assert store.latest_step(tmp_path / "t") == steps
    return jline, tline


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}
