"""``repro_torch.train.trainer`` on the CPU: resume, crash recovery, the
plan in the manifest, the observer, and a checkpoint of the JAX
package's ``Trainer`` continued by the port's.

Resumed and recovered runs equal the uninterrupted run to the bit (one
torch thread, the same host step counter and data stream).  The JAX
checkpoint restores to the bit and its continuation is held to the JAX
package's own continuation within rtol 1e-4 / atol 1e-5: the losses,
every optimizer-state leaf and every param leaf but the two sketched
vocabulary tables.  Their rows whose first-moment cells cancel turn the
last bits of the two packages' gradient sums into different steps
(measured: 3 of 262,144 ``tok_embed/table`` elements 9.4e-5 apart after
3 steps), so the tables are held looser: every element within atol 1e-3
and at most 16 outside rtol 1e-4 / atol 1e-5 (``test_torch_lm_step.py``
holds the step on the reference's gradients at rtol 1e-4 / atol 1e-5).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import ZipfLM as JZipf, ZipfLMConfig as JZipfCfg
from repro.train import steps as JS
from repro.train import trainer as JTR
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.core.partition import leaf_paths
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.train import steps as TS
from repro_torch.train.trainer import (Trainer, TrainerConfig, TrainState,
                                       wait_for)

CPU = torch.device("cpu")
TRAJ = dict(rtol=1e-4, atol=1e-5)
# the two sketched vocabulary tables of the JAX checkpoint's continuation
# (measured: 9.4e-5 at most, 3 of 262,144 elements outside TRAJ)
TABLE_ATOL, TABLE_OUTSIDE = 1e-3, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg():
    return tconfigs.get("qwen2_0_5b").reduced(vocab_size=2048)


def _data(cfg):
    return ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab, seq_len=16,
                               global_batch=2, seed=3))


def _setup(tmp, total, fail_at=None, ckpt_every=100, ckpt_async=True,
           **kw):
    cfg = _cfg()
    ts = TS.make_train_step(cfg, optimizer="cs_adam", kernel_backend="xla",
                            device=CPU, **kw)
    params = ts.init_fn(torch.Generator().manual_seed(0))
    state = TrainState(0, params, ts.optimizer.init(params))
    tr = Trainer(ts.step_fn, _data(cfg), TrainerConfig(
        total_steps=total, ckpt_dir=None if tmp is None else str(tmp),
        ckpt_every=ckpt_every, ckpt_async=ckpt_async), fail_at=fail_at,
        plan=kw.get("plan"), device=CPU)
    return tr, state


def _equal(a, b):
    fa, fb = leaf_paths(a), leaf_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), p


def test_resume_equals_the_uninterrupted_run_to_the_bit(tmp_path):
    tr_a, st_a = _setup(None, 6)
    out_a = tr_a.fit(st_a)
    tr_b, st_b = _setup(tmp_path, 3)
    tr_b.fit(st_b)
    assert store.latest_step(tmp_path) == 3
    tr_c, st_c = _setup(tmp_path, 6)
    resumed = tr_c.restore_or_init(st_c)
    assert resumed.step == 3
    out_c = tr_c.fit(resumed)
    assert out_c.step == out_a.step == 6
    _equal(out_c.params, out_a.params)
    _equal(out_c.opt_state, out_a.opt_state)
    assert [h["loss"] for h in tr_b.history + tr_c.history] == \
        [h["loss"] for h in tr_a.history]
    assert [h["step"] for h in tr_c.history] == [4, 5, 6]


def test_fail_at_then_recovery_is_bit_identical(tmp_path):
    tr_a, st_a = _setup(None, 8)
    out_a = tr_a.fit(st_a)
    tr_b, st_b = _setup(tmp_path, 8, fail_at=5, ckpt_every=2,
                        ckpt_async=False)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        tr_b.fit(st_b)
    resumed = tr_b.restore_or_init(st_b)
    assert resumed.step == 4
    out_b = tr_b.fit(resumed)        # fails once only
    assert out_b.step == 8
    _equal(out_b.params, out_a.params)
    _equal(out_b.opt_state, out_a.opt_state)
    assert [h["loss"] for h in tr_b.history[-4:]] == \
        [h["loss"] for h in tr_a.history[-4:]]


def test_manifest_records_and_recovers_the_plan(tmp_path):
    from repro_torch.plan import Plan, plan_for_config
    plan = plan_for_config(_cfg(), "floor")
    assert plan.n_by_mode()["sketch"] >= 1
    tr, st = _setup(tmp_path, 2, plan=plan)
    tr.fit(st)
    extra = store.read_manifest(tmp_path)["extra"]
    assert Plan.from_json(extra["plan"]) == plan
    assert extra["store_tree"] == plan.store_tree().to_json()
    tr2, st2 = _setup(tmp_path, 2)
    assert tr2.plan is None
    tr2.restore_or_init(st2)
    assert tr2.plan == plan
    with pytest.raises(ValueError, match="disagree"):
        Trainer(None, None, TrainerConfig(1), plan=plan,
                store_tree=plan.with_backend("xla").store_tree().__class__(),
                device=CPU)


def test_observer_and_monitor_see_every_step(tmp_path):
    from repro_torch.obs import MetricsWriter, RunObserver, validate_file
    writer = MetricsWriter(tmp_path / "m", run_meta={"workload": "lm"})
    obs = RunObserver(writer, log_every=2)
    tr, st = _setup(None, 4)
    tr.observer = obs
    tr.fit(st)
    recs = validate_file(next((tmp_path / "m").glob("*.jsonl")))
    steps = [r["step"] for r in recs if r["kind"] == "step"]
    assert steps == [2, 4]
    assert tr.monitor._count[0] == 4 and tr.monitor.stragglers() == []
    assert all(h["time_s"] > 0 and np.isfinite(h["loss"])
               for h in tr.history)
    wait_for(torch.zeros(()))          # a CPU tensor: nothing to wait on


def test_jax_trainer_checkpoint_continues_in_the_port(tmp_path):
    """A checkpoint the JAX ``Trainer`` wrote at step 3 restores into the
    port's ``Trainer`` (leaves matched by path, the host step counter),
    and the port's steps 4..6 follow the JAX package's own steps 4..6."""
    cfg_j = jconfigs.get("qwen2_0_5b").reduced(vocab_size=2048)
    jts = JS.make_train_step(cfg_j, optimizer="cs_adam",
                             kernel_backend="xla")
    params = jts.init_fn(jax.random.PRNGKey(0))
    jdata = JZipf(JZipfCfg(vocab_size=cfg_j.vocab, seq_len=16,
                           global_batch=2, seed=3))
    jstep = jax.jit(jts.step_fn)

    def jtrainer(total, d):
        return JTR.Trainer(jstep, jdata, JTR.TrainerConfig(
            total_steps=total, ckpt_dir=str(d), ckpt_every=100,
            ckpt_async=False))
    jtrainer(3, tmp_path / "j").fit(JTR.TrainState(
        0, params, jts.optimizer.init(params)))
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    jt = jtrainer(6, tmp_path / "j")
    js = jt.restore_or_init(JTR.TrainState(0, params,
                                           jts.optimizer.init(params)))
    assert js.step == 3
    jout = jt.fit(js)

    tr, st = _setup(tmp_path / "p", 6)
    resumed = tr.restore_or_init(st)
    assert resumed.step == 3 and int(resumed.opt_state["step"]) == 3
    # the restore and convert's copy of the JAX state give the same bits
    conv = convert.train_state_from_numpy(
        js.step, jax.device_get(js.params), jax.device_get(js.opt_state),
        CPU)
    assert conv.step == resumed.step
    _equal(resumed.params, conv.params)
    _equal(resumed.opt_state, conv.opt_state)
    step, p_np, s_np = convert.train_state_to_numpy(resumed)
    want = dict(leaf_paths(jax.device_get(js.params)))
    assert step == 3 and all(np.array_equal(x, want[p])
                             for p, x in leaf_paths(p_np))
    tout = tr.fit(resumed)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jt.history], **TRAJ)
    sketched = ("tok_embed/table", "lm_head/table")
    for tree_t, tree_j in ((tout.params, jout.params),
                           (tout.opt_state, jout.opt_state)):
        want = dict(leaf_paths(jax.device_get(tree_j)))
        got = leaf_paths(tree_t)
        assert sorted(p for p, _ in got) == sorted(want)
        for p, x in got:
            if tree_t is tout.params and p in sketched:
                _assert_table_close(x.numpy(), np.asarray(want[p]), p)
                continue
            np.testing.assert_allclose(x.numpy(), np.asarray(want[p]),
                                       **TRAJ, err_msg=p)


def _assert_table_close(got, want, path):
    """A sketched table after the continuation: every element within
    ``TABLE_ATOL`` and at most ``TABLE_OUTSIDE`` outside ``TRAJ``."""
    np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_ATOL,
                               err_msg=path)
    outside = ~np.isclose(got, want, **TRAJ)
    assert int(outside.sum()) <= TABLE_OUTSIDE, (path, int(outside.sum()))


def test_trainer_batches_go_to_its_device():
    seen = []

    def step(p, s, batch):
        seen.append({k: (v.device.type, v.dtype) for k, v in batch.items()})
        return p, s, {"loss": torch.zeros(())}
    cfg = _cfg()
    Trainer(step, _data(cfg), TrainerConfig(2), device=CPU).fit(
        TrainState(0, {}, {}))
    assert seen == [{"tokens": ("cpu", torch.int32),
                     "labels": ("cpu", torch.int32)}] * 2
