"""The torch examples (``examples_torch/``) run on the CPU at their
smallest sizes, each as a subprocess with its own deadline, and print
the device they ran on; their JAX counterparts in ``examples/`` stay as
they are.  ``elastic_recovery`` exits 1 unless its resumed losses equal
the uninterrupted run's."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 180.0               # s for one script
CASES = [("quickstart", []),
         ("train_lm_100m", ["--small", "--steps", "20", "--seq", "64"]),
         ("elastic_recovery", []),
         ("serve_decode", ["--arch", "yi_9b"]),
         ("serve_decode", ["--arch", "rwkv6_7b"])]


@pytest.mark.parametrize("name,args", CASES,
                         ids=[f"{n}{''.join(a[-1:])}" for n, a in CASES])
def test_example_runs_on_the_cpu(name, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         *args, "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=DEADLINE)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "device: cpu"
    if name == "elastic_recovery":
        assert "equal to the uninterrupted run's: True" in out.stdout
        assert "[2] trained 10 more steps" in out.stdout
    if name == "train_lm_100m":
        assert lines[-1].startswith("final: loss")
    if name == "serve_decode":
        assert any(l.startswith("decode  ") for l in lines)
