"""The port stands alone: no file of ``repro_torch``, ``chip_smoke.py``,
``tools/`` or ``examples_torch/`` imports ``jax`` or the reference package
``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import sketch\n"
                     "from repro_torch.core import sketch as ok\n")
    assert [m.split(".")[0] for m in _imports(probe)
            if m.split(".")[0] in FORBIDDEN] == ["jax", "repro"]


def test_the_check_covers_every_model_family():
    """Each family's module of the port is among the files checked."""
    models = {p.name for p in FILES if p.parent.name == "models"}
    assert {"transformer.py", "moe.py", "rwkv.py", "mamba.py", "encdec.py",
            "vlm.py"} <= models


def test_the_check_covers_the_examples_and_the_tooling():
    """The four torch examples and the dry run's modules are checked."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"examples_torch/{n}.py" for n in (
        "quickstart", "train_lm_100m", "elastic_recovery",
        "serve_decode")} <= names
    assert {f"src/repro_torch/launch/{n}.py" for n in (
        "analysis", "op_cost", "dryrun", "breakdown")} <= names
