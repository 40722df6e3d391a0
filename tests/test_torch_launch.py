"""The port's entry points on the CPU: ``python -m repro_torch.launch.train``
(in process, ``--device cpu``) against the JAX launcher, and
``repro_torch.plan.cli`` (``--arch``) against the JAX planner.

The launchers start from one state: the JAX launcher writes its step-0
checkpoint (``--steps 0``; ``replica{r}`` directories for ``--workload
extreme``), and both resume it on the same stream; their ``[train]``
lines agree to the printed digit (1e-3 for ``lm``, 1e-4 for
``extreme``'s losses; the words exactly).  ``serve-replay`` keeps no
checkpoint: the port serves the reference's table
(``launch.train.serve_table`` patched) and both servers run on one fake
clock, so batching and shedding do not depend on measured adapt times.
Plans are held to the reference's JSON exactly, at full shapes built on
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
    (["--arch", "zamba2_2_7b", "--reduced"], "zamba2-2.7b-smoke"),
    (["--arch", "rwkv6_7b", "--reduced"], "rwkv6-7b-smoke"),
])
def test_launcher_errors_name_their_roadmap_items(args, label, tmp_path,
                                                  monkeypatch, capsys):
    """The families once refused (ROADMAP A14b part 4) run: 2 steps from
    the JAX launcher's step-0 checkpoint, the ``[train]`` line held to
    the JAX launcher's."""
    _jax_main(monkeypatch, capsys, args + ["--steps", "0", "--ckpt-dir",
                                           str(tmp_path / "j")])
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    more = ["--steps", "2", "--ckpt-dir"]
    jline, jloss = _loss_line(_jax_main(
        monkeypatch, capsys, args + more + [str(tmp_path / "j")]))
    tline, tloss = _loss_line(_port_main(
        capsys, args + more + [str(tmp_path / "t")]))
    assert tline.startswith(f"[train] arch={label} optimizer=cs_adam "
                            f"dp=False steps=2 loss ")
    assert tline.split(" loss ")[0] == jline.split(" loss ")[0]
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-3)
    assert store.latest_step(tmp_path / "t") == 2


@pytest.mark.parametrize("flag", [["--classes", "100"],
                                  ["--serve-requests", "10"]])
def test_launcher_refuses_flags_of_workloads_not_ported(flag, capsys):
    """The flags that only the extreme and serve-replay workloads read
    (once refused, as those workloads were not ported) reach their
    workload's output line."""
    if flag[0] == "--classes":
        out = _port_main(capsys, flag + EXTREME + ["--steps", "3"])
        assert "[train] workload=extreme classes=100 " in out
    else:
        out = _port_main(capsys, flag + SERVE)
        assert re.search(r"^\[serve\] arm=countmin .* requests=10 ", out,
                         re.M)


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
    # the families once refused plan too (rwkv6-7b: tests/test_torch_rwkv.py)
    assert TCLI.main(["--arch", "rwkv6_7b", "--budget", "floor"]) == 0
    assert "[plan]" in capsys.readouterr().out


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


# ------------------------------------------------------------------ extreme
# small MACH tables (every table sketched at 0.25x), 12 steps a replica
EXTREME = ["--workload", "extreme", "--meta-rows", "4096", "--features",
           "4096", "--extreme-dim", "16", "--nnz", "4", "--negatives", "64",
           "--batch", "32", "--lr", "1e-2", "--replicas", "2"]
EXTREME_LINE = re.compile(r"^\[train\] workload=extreme .*$", re.M)


def _extreme_pair(tmp_path, monkeypatch, capsys, extra, steps=12):
    """Both launchers resume the JAX launcher's step-0 ``replica{r}``
    checkpoints for ``steps`` steps; their ``[train] workload=extreme``
    lines."""
    from repro.launch import train as JL
    base = EXTREME + ["--classes", "5000"] + extra
    monkeypatch.setattr(sys, "argv", ["repro.launch.train"] + base + [
        "--steps", "0", "--ckpt-dir", str(tmp_path / "j")])
    # --steps 0 leaves no loss history, so the reference exits 1
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        assert JL.main() == 1
    for r in (0, 1):
        assert store.latest_step(tmp_path / "j" / f"replica{r}") == 0
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jout = _jax_main(monkeypatch, capsys, base + [
        "--steps", str(steps), "--ckpt-dir", str(tmp_path / "j")])
    tout = _port_main(capsys, base + ["--steps", str(steps), "--ckpt-dir",
                                      str(tmp_path / "t")])
    return EXTREME_LINE.findall(jout), EXTREME_LINE.findall(tout), tout


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


@pytest.mark.parametrize("extra", [[], ["--aux-budget", "0.25x"],
                                   ["--dp", "--error-feedback"]],
                         ids=["plain", "aux_budget", "dp_feedback"])
def test_extreme_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                               capsys, extra):
    """Each replica's line and the summary to the printed digit (the
    words exactly, each loss within 1e-4); under ``--dp`` a gloo group
    of one stands for the reference's one device."""
    if "--dp" in extra:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
            world_size=1)
    try:
        jlines, tlines, tout = _extreme_pair(tmp_path, monkeypatch, capsys,
                                             extra)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert len(tlines) == len(jlines) == 3
    for t, j in zip(tlines, jlines):
        assert re.sub(r"-?\d+\.\d+", "#", t) == re.sub(r"-?\d+\.\d+", "#", j)
        np.testing.assert_allclose(_numbers(t), _numbers(j), rtol=0,
                                   atol=1e-4)
    assert tlines[-1].startswith(
        "[train] workload=extreme classes=5,000 meta_rows=4,096 replicas=2 "
        f"optimizer=cs_rmsprop dp={'--dp' in extra} batch=32 per-replica "
        "losses [")
    if extra[:1] == ["--aux-budget"]:
        assert "tok_embed/table" in tout and "class_head/table" in tout
    for r in (0, 1):
        assert store.latest_step(tmp_path / "t" / f"replica{r}") == 12


def test_extreme_metrics_dir_holds_each_replicas_monitors(tmp_path, capsys):
    m = tmp_path / "m"
    out = _port_main(capsys, EXTREME + [
        "--classes", "5000", "--steps", "4", "--metrics-dir", str(m),
        "--log-every", "2"])
    # an --optimizer left at the LM's default runs cs_rmsprop, as in the
    # reference (so cs_adam cannot be asked for by name here either)
    assert "optimizer=cs_rmsprop" in out
    from repro_torch.obs import validate_file
    for r in (0, 1):
        recs = validate_file(m / f"replica{r}" / "metrics.jsonl")
        assert recs[0]["run"]["replica"] == r
        tables = {x["table"] for x in recs if x["kind"] == "table"}
        assert tables == {"tok_embed/table", "class_head/table"}


# ------------------------------------------------------------- serve-replay
SERVE = ["--workload", "serve-replay", "--sparse-rows", "512",
         "--sparse-dim", "8", "--offered-load", "2000", "--serve-batch-ids",
         "32", "--serve-deadline-ms", "2", "--queue-cap", "6", "--lr", "1e-2"]
SERVE_LINE = re.compile(r"^\[serve\] .*$", re.M)


@pytest.mark.parametrize("arm", ["countmin", "dense"])
def test_serve_replay_matches_the_jax_launcher(tmp_path, monkeypatch, capsys,
                                               arm):
    """One trace through each launcher with both servers' clocks replaced
    by one fake clock (``tests/test_torch_serve.py``), so batching and
    shedding do not depend on the measured adapt time; the port serves
    the reference's table (``launch.train.serve_table`` patched).  The
    line's words, requests, batches and shed rate equal the reference's
    (the adapt times are measured, not compared), the published table
    within rtol 1e-4, atol 1e-5, and the ``serve`` records hold the same
    keys and the same trace statistics."""
    import jax
    import repro.serve as jserve
    import repro.serve.server as jserver_mod
    import repro_torch.serve as tserve
    import repro_torch.serve.server as tserver_mod
    from repro.obs.metrics import validate_file as j_validate
    from repro_torch.obs import validate_file
    from test_torch_serve import _FakeClock
    servers = {}

    def keep(mod, name):
        base = mod.AdaptServer

        class Kept(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                servers[name] = self
        monkeypatch.setattr(mod, "AdaptServer", Kept)

    keep(jserve, "j")
    keep(tserve, "t")
    monkeypatch.setattr(jserver_mod, "time", _FakeClock())
    monkeypatch.setattr(tserver_mod, "time", _FakeClock())
    table = np.array(jax.random.normal(jax.random.PRNGKey(0), (512, 8))
                     * 0.1)
    monkeypatch.setattr(TL, "serve_table", lambda n, d, seed, device:
                        torch.from_numpy(table.copy()).to(device))
    args = SERVE + (["--optimizer", "dense_adam"] if arm == "dense" else [])
    jline = SERVE_LINE.findall(_jax_main(monkeypatch, capsys, args + [
        "--metrics-dir", str(tmp_path / "j")]))
    tline = SERVE_LINE.findall(_port_main(capsys, args + [
        "--metrics-dir", str(tmp_path / "t")]))
    assert len(jline) == len(tline) == 1
    cut = re.compile(r" adapt p50 .*$")
    assert cut.sub("", tline[0]) == cut.sub("", jline[0])
    assert tline[0].startswith(f"[serve] arm={arm} rows=512 dim=8 "
                               f"load=2000/s requests=256 ")
    j, t = servers["j"], servers["t"]
    assert (t.n_batches, t.n_shed) == (j.n_batches, j.n_shed)
    assert t.n_shed > 0 and t.n_batches > 5
    np.testing.assert_allclose(t.store.read().table.numpy(),
                               np.asarray(j.store.read().table),
                               rtol=1e-4, atol=1e-5)
    jrec = [r for r in j_validate(tmp_path / "j" / "metrics.jsonl")
            if r["kind"] == "serve"]
    trec = [r for r in validate_file(tmp_path / "t" / "metrics.jsonl")
            if r["kind"] == "serve"]
    assert len(jrec) == len(trec) == 1
    assert sorted(trec[0]) == sorted(jrec[0])
    for k in jrec[0]:
        if k.startswith("trace_") or k in ("n_requests", "n_batches",
                                           "n_shed", "shed_rate",
                                           "offered_load"):
            assert trec[0][k] == jrec[0][k], k


# ---------------------------------------------------------------- MoE archs
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b",
                                  "llama4_maverick_400b_a17b"])
def test_moe_arch_loss_line_matches_the_jax_launcher(tmp_path, monkeypatch,
                                                     capsys, arch):
    base = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "32"]
    _jax_main(monkeypatch, capsys, base + ["--steps", "0", "--ckpt-dir",
                                           str(tmp_path / "j")])
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jline, jloss = _loss_line(_jax_main(
        monkeypatch, capsys, base + ["--steps", "3", "--ckpt-dir",
                                     str(tmp_path / "j")]))
    tline, tloss = _loss_line(_port_main(
        capsys, base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "t")]))
    name = tconfigs.get(arch).reduced().name
    assert tline.startswith(f"[train] arch={name} optimizer=cs_adam "
                            "dp=False steps=3 loss ")
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-3)


@pytest.mark.parametrize("budget", ["floor", "0.96x", "0.85x"])
def test_moe_plan_for_config_json_equals_the_reference(budget):
    """qwen2-moe-a2.7b at full shapes (the port's on ``meta``).  Its
    expert leaves are not tables, so the floor is 0.957x of dense: at
    0.85x both planners refuse with the same words."""
    from repro import configs as jconfigs
    from repro.plan import plan_for_config as jplan
    try:
        jp = jplan(jconfigs.get("qwen2_moe_a2_7b"), budget)
    except Exception as e:       # the reference's InfeasibleBudgetError
        with pytest.raises(Exception) as te:
            TCLI.plan_for_config(tconfigs.get("qwen2_moe_a2_7b"), budget)
        assert (type(te.value).__name__, str(te.value)) == \
            (type(e).__name__, str(e))
        assert budget == "0.85x" and "below the plan floor" in str(e)
        return
    tp = TCLI.plan_for_config(tconfigs.get("qwen2_moe_a2_7b"), budget)
    assert tp.to_json() == jp.to_json()
    assert tp.store_tree().to_json() == jp.store_tree().to_json()


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b",
                                  "llama4_maverick_400b_a17b"])
@pytest.mark.parametrize("mesh", ["2x4", "16x16", "pod"])
def test_moe_param_specs_equal_the_references(arch, mesh):
    """The MoE params' placement (``param_specs`` of the port's ``meta``
    tree under the config's ``expert_sharding``, and under the other) on
    the device-free meshes of ``tests/test_torch_sharding.py``."""
    from repro import configs as jconfigs
    from repro.distributed import sharding as J
    from repro.plan import cli as JCLI
    from repro_torch.distributed import sharding as T
    from test_torch_sharding import _jflat, _mesh, _tflat
    m = _mesh(mesh)
    tps = TCLI.params_shapes_for_config(tconfigs.get(arch))
    jps = JCLI.params_shapes_for_config(jconfigs.get(arch))
    for es in ("ep", "tp"):
        for fsdp in (False, True):
            got = _tflat(T.param_specs(tps, m, fsdp=fsdp,
                                       expert_sharding=es), tps)
            want = _jflat(J.param_specs(jps, m, fsdp=fsdp,
                                        expert_sharding=es))
            assert got == want, (es, fsdp)
    assert any("w_gate" in p for p in got)


# ------------------------------------------------------------ adam_rows_fused
@pytest.mark.parametrize("track_m", [True, False])
def test_adam_rows_fused_matches_the_reference(track_m):
    """``ops.adam_rows_fused`` on CPU tensors is the per-item loop, as the
    reference's off its accelerator (``ref``): rtol 1e-5, atol 1e-6 (one
    backend call, ``tests/test_torch_backends.py``)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    from test_torch_backends import _inputs, _specs
    (jm, jv), (tm, tv) = _specs(512, 16, 3)
    M, V, ids, g = _inputs(jv, 48, 512, track_m, seed=3)
    want = jops.adam_rows_fused(
        jm if track_m else None, jv, None if M is None else jnp.asarray(M),
        jnp.asarray(V), jnp.asarray(ids), jnp.asarray(g),
        jnp.asarray(2, jnp.int32), lr=1e-2, b1=0.9, b2=0.999, eps=1e-8)

    def port(force=None):
        return tops.adam_rows_fused(
            tm if track_m else None, tv,
            None if M is None else torch.from_numpy(M.copy()),
            torch.from_numpy(V.copy()), torch.from_numpy(ids.copy()),
            torch.from_numpy(g.copy()), torch.tensor(2), lr=1e-2, b1=0.9,
            b2=0.999, eps=1e-8, force=force)
    got = port()
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
    forced = port("ref")
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, forced))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            port("cuda")
    with pytest.raises(ValueError, match="force"):
        port("pallas")
