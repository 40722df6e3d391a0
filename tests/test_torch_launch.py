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
    (["--workload", "extreme"], "A14b"),
    (["--workload", "serve-replay"], "A14b"),
    (["--arch", "rwkv6_7b", "--reduced"], "A14b"),
    (["--arch", "qwen2_moe_a2_7b", "--reduced"], "A14b"),
])
def test_launcher_errors_name_their_roadmap_items(args, label):
    with pytest.raises(NotImplementedError, match=label):
        TL.main(args + ["--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("flag", [["--classes", "100"],
                                  ["--serve-requests", "10"]])
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


# ---------------------------------------------------------- sparse_embedding
# the reference's own launcher test's shapes, at an lr where the loss of
# both of its routes falls in 20 steps
SPARSE = ["--workload", "sparse_embedding", "--sparse-rows", "4096",
          "--sparse-dim", "32", "--batch", "16", "--seq", "16",
          "--lr", "0.01", "--ckpt-every", "10"]


def _jax_target(monkeypatch, seed=0):
    """The port launcher's target replaced by the reference's
    ``init_fn(PRNGKey(seed + 1))``, as a copy on the CPU."""
    import jax
    from repro.train.steps import make_sparse_embedding_step as jmake
    init_fn, _, _ = jmake(4096, 32)
    target = np.array(init_fn(jax.random.PRNGKey(seed + 1)))
    monkeypatch.setattr(TL, "sparse_target", lambda _init, _seed, device:
                        torch.from_numpy(target.copy()).to(device))


def _sparse_pair(tmp_path, monkeypatch, capsys, extra, steps=20):
    """Both launchers resume the JAX launcher's step-0 checkpoint for
    ``steps`` steps; their ``[train]`` lines."""
    # --steps 0 leaves no loss history, so the reference exits 1
    from repro.launch import train as JL
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + SPARSE + extra
                        + ["--steps", "0", "--ckpt-dir", str(tmp_path / "j")])
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        assert JL.main() == 1
    assert store.latest_step(tmp_path / "j") == 0
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jline, jloss = _loss_line(_jax_main(
        monkeypatch, capsys, SPARSE + extra + [
            "--steps", str(steps), "--ckpt-dir", str(tmp_path / "j")]))
    _jax_target(monkeypatch)
    tline, tloss = _loss_line(_port_main(
        capsys, SPARSE + extra + ["--steps", str(steps), "--ckpt-dir",
                                  str(tmp_path / "t")]))
    return jline, tline


@pytest.fixture
def gloo_world_1(tmp_path):
    """A one-process gloo group over a ``file://`` rendezvous, the port's
    counterpart of the reference's one CPU device under ``--dp``."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
        world_size=1)
    yield
    torch.distributed.destroy_process_group()


def test_sparse_embedding_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                                        capsys):
    jline, tline = _sparse_pair(tmp_path, monkeypatch, capsys, [])
    assert tline == jline
    assert tline.startswith("[train] workload=sparse_embedding rows=4096 "
                            "dim=32 dp=False shards=1(width) "
                            "feedback=False steps=20 loss ")
    assert store.latest_step(tmp_path / "t") == 20


def test_sparse_embedding_dp_feedback_matches_the_jax_launcher(
        tmp_path, monkeypatch, capsys, gloo_world_1):
    jline, tline = _sparse_pair(tmp_path, monkeypatch, capsys,
                                ["--dp", "--error-feedback"])
    assert "dp=True" in tline and "feedback=True" in tline
    assert tline == jline
    # the residual rides in the checkpoint, as the reference's
    names = {e["path"] for e in store.read_manifest(tmp_path / "t")["leaves"]}
    assert names == {e["path"] for e in
                     store.read_manifest(tmp_path / "j")["leaves"]}
    assert "opt_state/residual" in names


def test_sparse_embedding_resumes_in_either_package(tmp_path, monkeypatch,
                                                    capsys):
    """A fresh port run's checkpoint loads in the JAX package's restore and
    resumes in its launcher; a resume under another cell dtype is refused
    in the reference's words."""
    d = str(tmp_path / "p")
    # the exit codes say whether the loss fell (this resumes across two
    # targets); what is held here is the checkpoint
    assert TL.main(SPARSE + ["--steps", "10", "--ckpt-dir", d, "--device",
                             "cpu"]) in (0, 1)
    from repro.checkpoint import store as jstore
    from repro.launch import train as JL
    jstep, jtree = jstore.restore(d, {"params": 0, "opt_state": {
        "step": 0, "m": 0, "v": 0}})
    tstep, ttree = store.restore(d, {"params": 0, "opt_state": {
        "step": 0, "m": 0, "v": 0}}, device="cpu")
    assert jstep == tstep == 10
    for k in ("m", "v"):
        np.testing.assert_array_equal(np.asarray(jtree["opt_state"][k]),
                                      ttree["opt_state"][k].numpy())
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + SPARSE + [
        "--steps", "30", "--ckpt-dir", d])
    capsys.readouterr()
    assert JL.main() in (0, 1)
    assert "steps=30 loss" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + SPARSE + [
        "--steps", "40", "--ckpt-dir", d, "--sketch-cell-dtype",
        "bfloat16"])
    with pytest.raises(ValueError) as je:
        JL.main()
    with pytest.raises(ValueError) as te:
        TL.main(SPARSE + ["--steps", "40", "--ckpt-dir", d,
                          "--sketch-cell-dtype", "bfloat16", "--device",
                          "cpu"])
    assert str(te.value) == str(je.value)
    assert "'float32' cells" in str(te.value)


def test_sparse_embedding_flags_checked_as_in_the_reference(capsys):
    with pytest.raises(SystemExit):
        TL.main(SPARSE + ["--probe-rows", "8", "--device", "cpu"])
    assert "--probe-rows needs --metrics-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        TL.main(SPARSE + ["--dp", "--sketch-cell-dtype", "int8",
                          "--device", "cpu"])
    assert "does not compose with --dp" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        TL.main(["--sketch-shards", "2", "--device", "cpu"])
    assert "sparse_embedding workload only" in capsys.readouterr().err
    with pytest.raises(ValueError, match="divisible by it"):
        TL.main(SPARSE + ["--sketch-shards", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="need a process group"):
        TL.main(SPARSE + ["--dp", "--device", "cpu"])


def test_sparse_embedding_probes_and_cleaning(tmp_path, capsys):
    m = tmp_path / "m"
    out = _port_main(capsys, SPARSE + [
        "--steps", "20", "--metrics-dir", str(m), "--probe-rows", "8",
        "--log-every", "5", "--cleaning-every", "4", "--cleaning-mode",
        "async", "--lr", "0.001"])
    assert "workload=sparse_embedding" in out
    from repro_torch.obs import validate_file
    recs = validate_file(next(m.glob("*.jsonl")))
    tables = [r for r in recs if r["kind"] == "table"]
    assert [r["step"] for r in tables] == [5, 10, 15, 20]
    assert all(r["table"] == "sparse_embedding" and r["probe_rows"] == 8
               and np.isfinite(r["v_meas_error"]) for r in tables)
    assert sum(r["cleans_in_window"] for r in tables) == 5


def test_lm_dp_at_world_1_equals_the_plain_run(tmp_path, capsys,
                                               gloo_world_1):
    base = ["--arch", "qwen2_0_5b", "--reduced", "--batch", "2", "--seq",
            "16", "--steps", "2"]
    _, plain = _loss_line(_port_main(capsys, base))
    line, dp = _loss_line(_port_main(capsys, base + ["--dp"]))
    assert "dp=True" in line
    assert dp == plain
