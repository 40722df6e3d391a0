"""A run of the harness on the CPU at tiny sizes, with the look for a
chip skipped: a sound program comes out correct, and the timed path
broken underneath (its state returned unchanged; half of the batch left
out) comes out not correct under the cells' committed limits.  The
control, the precision below the configuration's, does too."""
from __future__ import annotations

import copy
import math
import subprocess
import sys
import time

import pytest
import torch

from harness_tiny import BENCH, ROOT, tiny_spec
from harness.runner import run_cell

CELLS = ["qwen2-0.5b.sparse_rows", "qwen2-0.5b.lm_train_b8",
         "rwkv6-7b.lm_train"]


def _run(spec, trace=False):
    return run_cell(spec, 2**31 + 99, 0.2, trace, torch.device("cpu"),
                    time.perf_counter())


def _break(monkeypatch, kind: str, fault: str):
    """Patch the program's step factory so that its step ``fault``s."""
    from repro_torch.train import steps
    if kind == "sparse_rows":
        orig = steps.make_sparse_embedding_step

        def factory(*a, **k):
            init, step, opt = orig(*a, **k)

            def broken(table, state, ids, rows):
                if fault == "frozen":
                    step(table.clone(), copy.deepcopy(state), ids, rows)
                    return table, state
                h = ids.shape[0] // 2
                return step(table, state, ids[:h], rows[:h])
            return init, broken, opt
        monkeypatch.setattr(steps, "make_sparse_embedding_step", factory)
        return
    orig_lm = steps.make_train_step

    def lm_factory(*a, **k):
        ts = orig_lm(*a, **k)
        step = ts.step_fn

        def broken(params, opt_state, batch):
            if fault == "frozen":
                _p, _s, metrics = step(copy.deepcopy(params),
                                       copy.deepcopy(opt_state), batch)
                return params, opt_state, metrics
            h = batch["tokens"].shape[0] // 2
            return step(params, opt_state,
                        {k: v[:h] for k, v in batch.items()})
        ts.step_fn = broken
        return ts
    monkeypatch.setattr(steps, "make_train_step", lm_factory)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(tiny_spec(cell))
    assert res["correct"], res["check"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", ["frozen", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    spec = tiny_spec(cell)
    _break(monkeypatch, spec.traffic["kind"], fault)
    assert not _run(spec)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import control
    from harness import check, manifest
    spec = tiny_spec(cell)
    got = control.readings(spec, 5, torch.device("cpu"))
    limits = manifest.limits_of(spec)
    assert check.verdict(got["sound"], limits)[0]
    assert not check.verdict(got["control"], limits)[0]
    assert not check.verdict(got["half"], limits)[0]


def test_numbers_split_the_layers_from_the_sketched_tables():
    from harness import check
    ref = {"loss": [2.0], "grad1": {"t": 1.0, "w": 1.0, "b": 1.0},
           "state1": {"m/t": 1.0, "v/t": 1.0, "m/w": 1.0, "v/w": 1.0,
                      "m/b": 1.0, "v/b": 1.0},
           "change": {"t": 1.0, "w": 1.0, "b": 1.0}}
    prog = {"loss": [2.0], "state1": dict(ref["state1"], **{
                "m/t": 1.5, "v/w": 1.1, "m/b": 0.8}),
            "change": dict(ref["change"], w=1.2)}
    got = check.gaps(prog, ref, sketched=("t",))
    assert got["state_gap"] == pytest.approx(0.5)
    assert got["state_tables_gap"] == pytest.approx(0.5)
    assert got["state_layers_gap"] == pytest.approx(0.2)
    assert got["moment2_layers_gap"] == pytest.approx(0.1)
    assert got["change_layers_gap"] == pytest.approx(0.2)
    alone = check.gaps(prog, ref, sketched=("t", "w", "b"))
    assert alone["state_layers_gap"] is None
    assert not check.verdict(alone, {"state_layers_gap": 1.0})[0]


def test_shape_numbers_take_out_a_factor_common_to_the_layers():
    from harness import check
    keys = ("w", "u", "b")
    ref = {"loss": [2.0], "grad1": dict.fromkeys(keys, 1.0),
           "state1": {f"{m}/{k}": 1.0 for m in "mv" for k in keys},
           "change": dict.fromkeys(keys, 1.0)}
    scaled = {"loss": [2.0], "change": ref["change"],
              "state1": {k: 1.01 for k in ref["state1"]}}
    got = check.gaps(scaled, ref)
    assert got["moment2_layers_gap"] == pytest.approx(0.01)
    assert got["moment2_layers_shape_gap"] == pytest.approx(0.0)
    one_leaf = dict(scaled, state1=dict(scaled["state1"], **{"v/u": 1.212}))
    got = check.gaps(one_leaf, ref)
    assert got["moment2_layers_shape_gap"] == pytest.approx(0.2)
    zero = dict(scaled, state1=dict.fromkeys(ref["state1"], 0.0))
    assert check.gaps(zero, ref)["moment2_layers_shape_gap"] == 1.0


@pytest.mark.parametrize("leaf", ["b", "u", "w"])
@pytest.mark.parametrize("moment,number", [
    ("m", "state_layers_gap"), ("v", "moment2_layers_gap"),
    ("v", "moment2_layers_shape_gap"), ("loss", "loss_gap")])
def test_a_gap_that_is_not_a_number_is_not_passed_over(leaf, moment, number):
    from harness import check
    keys = ("w", "u", "b")
    ref = {"loss": [2.0, 2.0, 2.0], "grad1": dict.fromkeys(keys, 1.0),
           "state1": {f"{m}/{k}": 1.0 for m in "mv" for k in keys},
           "change": dict.fromkeys(keys, 1.0)}
    prog = {"loss": list(ref["loss"]), "change": ref["change"],
            "state1": dict(ref["state1"])}
    if moment == "loss":
        prog["loss"][sorted(keys).index(leaf)] = float("nan")
    else:
        prog["state1"][f"{moment}/{leaf}"] = float("nan")
    got = check.gaps(prog, ref)
    assert math.isnan(got[number])
    assert not check.verdict(got, {number: 1.0})[0]


def test_traced_run_reports_what_a_cpu_can_count():
    res = _run(tiny_spec("qwen2-0.5b.lm_train_b8"), trace=True)
    assert set(res["metrics"]) == {"step_mfu.lm", "opt_state_gib"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "qwen2-0.5b.sparse_rows", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qwen2-0.5b.sparse_rows"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "2147483701", "--seconds", "2"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
