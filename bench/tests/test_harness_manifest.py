"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every file of a cell by name."""
from __future__ import annotations

import json
import re

import pytest

from harness_tiny import BENCH, ROOT, manifest
from harness import check

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"]
    assert M["command"] == ["python3", "bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_every_config_has_a_cell_and_each_cell_reports_enough():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for cell in CELLS:
        spec = manifest.cell(cell)
        e2e = [m["name"] for m in spec.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer


def test_moves_is_reported_in_each_of_its_metrics_cells():
    e2e = {m["name"]: set(m.get("workloads", CELLS)) for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]


def test_metric_lists_name_only_cells_whose_files_exist():
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    for w in M["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers == {"whole step", "model forward and backward",
                      "optimizer and its state", "kernels",
                      "host dispatch", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    spec = manifest.cell(cell)
    assert spec.config["name"] == spec.config_name
    assert spec.traffic["kind"] in ("sparse_rows", "lm_train")
    assert hasattr(manifest.kind(spec.traffic), "Cell")
    limits = manifest.limits_of(spec)
    assert set(limits) == set(check.NUMBERS)
    assert any(v is not None for v in limits.values())
    for m in spec.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_metric_reader_has_a_file():
    for m in M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
