"""The port's entry points on the CPU: ``python -m repro_torch.launch.train``
(in process, ``--device cpu``) against the JAX launcher, and
``repro_torch.plan.cli`` (``--arch``) against the JAX planner.

The launchers start from one state: the JAX launcher writes its step-0
checkpoint (``--steps 0``), and both resume it for 3 steps on the same
``ZipfLM`` stream; their ``[train]`` loss lines agree to the printed
digit (1e-3; the losses themselves within rtol 1e-4).  Plans are held
to the reference's JSON exactly, at qwen2-0.5b's full shapes built on
the ``meta`` device (no allocation).
"""
import json
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store
from repro_torch.launch import train as TL
from repro_torch.plan import cli as TCLI

LOSS = re.compile(r"loss (\S+) -> (\S+)")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_main(monkeypatch, capsys, args):
    from repro.launch import train as JL
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + args)
    capsys.readouterr()
    assert JL.main() == 0
    return capsys.readouterr().out


def _port_main(capsys, args):
    capsys.readouterr()
    assert TL.main(args + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def _loss_line(out):
    line = [l for l in out.splitlines() if l.startswith("[train]")][-1]
    return line, tuple(float(x) for x in LOSS.search(line).groups())


def test_launcher_loss_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                                     capsys):
    base = ["--arch", "qwen2_0_5b", "--reduced"]
    _jax_main(monkeypatch, capsys, base + ["--steps", "0", "--ckpt-dir",
                                           str(tmp_path / "j")])
    assert store.latest_step(tmp_path / "j") == 0
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jline, jloss = _loss_line(_jax_main(
        monkeypatch, capsys, base + ["--steps", "3", "--ckpt-dir",
                                     str(tmp_path / "j")]))
    tline, tloss = _loss_line(_port_main(
        capsys, base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "t")]))
    assert tline.startswith("[train] arch=qwen2-0.5b-smoke optimizer=cs_adam "
                            "dp=False steps=3 loss ")
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-3)
    assert store.latest_step(tmp_path / "t") == 3


def test_launcher_runs_fresh_and_records_the_plan(tmp_path, capsys):
    """A fresh run (the port's own init) with ``--metrics-dir``, then
    ``--aux-budget floor`` on
    ``--store-backend tiled``: the plan rides in the manifest with its
    backend, a resume without the flags recovers it, and a recorded
    ``tiled`` stays ``tiled`` (on a card it is B3; no fallback)."""
    base = ["--arch", "qwen2_0_5b", "--reduced", "--batch", "2", "--seq",
            "16"]
    m = tmp_path / "metrics"
    _, (first, last) = _loss_line(_port_main(
        capsys, base + ["--steps", "2", "--metrics-dir", str(m),
                        "--log-every", "1"]))
    assert np.isfinite([first, last]).all()
    from repro_torch.obs import validate_file
    recs = validate_file(next(m.glob("*.jsonl")))
    assert [r["step"] for r in recs if r["kind"] == "step"] == [1, 2]
    d = str(tmp_path / "p")
    out = _port_main(capsys, base + ["--steps", "2", "--aux-budget", "floor",
                                     "--store-backend", "tiled",
                                     "--ckpt-dir", d])
    assert "[plan] store backend -> tiled" in out
    plan0 = store.read_manifest(d)["extra"]["plan"]
    assert plan0["backend"] == "tiled"
    out = _port_main(capsys, base + ["--steps", "3", "--ckpt-dir", d])
    assert "[plan] recovered from checkpoint manifest" in out
    assert "TPU" not in out
    assert store.read_manifest(d)["extra"]["plan"] == plan0
    # re-solving the same budget on resume keeps the recorded backend
    _port_main(capsys, base + ["--steps", "4", "--ckpt-dir", d,
                               "--aux-budget", "floor"])
    assert store.read_manifest(d)["extra"]["plan"] == plan0
    assert store.latest_step(d) == 4


@pytest.mark.parametrize("args,label", [
    (["--dp"], "A13"),
    (["--sketch-shards", "2"], "A13"),
    (["--error-feedback"], "A13"),
    (["--workload", "sparse_embedding"], "A14b"),
    (["--workload", "extreme"], "A14b"),
    (["--workload", "serve-replay"], "A14b"),
    (["--arch", "rwkv6_7b", "--reduced"], "A14b"),
    (["--arch", "qwen2_moe_a2_7b", "--reduced"], "A14b"),
])
def test_launcher_errors_name_their_roadmap_items(args, label):
    with pytest.raises(NotImplementedError, match=label):
        TL.main(args + ["--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("flag", [
    ["--cleaning-every", "5"], ["--probe-rows", "8"], ["--classes", "100"],
    ["--serve-requests", "10"], ["--shard-layout", "hash"]])
def test_launcher_refuses_flags_of_workloads_not_ported(flag, capsys):
    """Flags that only the other workloads read are not parsed: passing
    one is an error, not a silently ignored knob."""
    with pytest.raises(SystemExit) as e:
        TL.main(flag + ["--steps", "1", "--device", "cpu"])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("budget", ["config", "0.85x", "floor"])
def test_plan_for_config_json_equals_the_reference(budget):
    from repro import configs as jconfigs
    from repro.plan import plan_for_config as jplan
    jp = jplan(jconfigs.get("qwen2_0_5b"), budget)
    tp = TCLI.plan_for_config(tconfigs.get("qwen2_0_5b"), budget)
    assert tp.to_json() == jp.to_json()
    assert tp.store_tree().to_json() == jp.store_tree().to_json()


def test_params_shapes_allocate_nothing_and_match_the_reference():
    import jax
    from repro import configs as jconfigs
    from repro.plan import cli as JCLI
    from repro_torch.core.partition import leaf_paths
    ps = TCLI.params_shapes_for_config(tconfigs.get("qwen2_0_5b"))
    js = JCLI.params_shapes_for_config(jconfigs.get("qwen2_0_5b"))
    tflat = {p: (tuple(x.shape), str(x.dtype).split(".")[1])
             for p, x in leaf_paths(ps)}
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path):
             (tuple(x.shape), str(x.dtype))
             for path, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    assert tflat == jflat
    assert all(x.device.type == "meta" for _, x in leaf_paths(ps))


def test_plan_cli_matches_the_reference(tmp_path, capsys):
    from repro.plan import cli as JCLI
    argv = ["--arch", "qwen2_0_5b", "--budgets", "floor,config,1.0x",
            "--check"]
    assert JCLI.main(argv + ["--json", str(tmp_path / "j.json")]) == 0
    jout = capsys.readouterr().out
    assert TCLI.main(argv + ["--json", str(tmp_path / "t.json")]) == 0
    tout = capsys.readouterr().out
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    # the same tables and verdicts, line for line
    keep = [l for l in jout.splitlines()
            if not l.startswith("[plan] wrote")]
    assert keep == [l for l in tout.splitlines()
                    if not l.startswith("[plan] wrote")]
    assert tout.count("[check] OK") == 3
    with pytest.raises(NotImplementedError, match="A14b"):
        TCLI.main(["--arch", "rwkv6_7b", "--budget", "floor"])
