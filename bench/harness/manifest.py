"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is run from:

* ``bench/configs/<config>.json``: the configuration's sizes as run (the
  manifest's ``file``);
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``kind`` names the driver in ``bench/harness/kinds/<kind>.py``;
* ``bench/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric.

A later cell, mix, configuration or metric is a new file and a new entry,
never an edit of a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell(name: str, root: Path = ROOT) -> CellSpec:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics read from their files."""
    root = Path(root)
    manifest = load(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / "bench"
    return CellSpec(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=_for_cell(manifest["end_to_end"], name),
        per_layer=_for_cell(manifest["per_layer"], name))


def kind(traffic: dict):
    """The driver module of a traffic mix's ``kind``."""
    return importlib.import_module(f"harness.kinds.{traffic['kind']}")


def reader(metric: str, bench: Path = BENCH) -> Callable:
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = Path(bench) / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits_of(spec: CellSpec) -> Dict[str, Optional[float]]:
    """``{number: limit}`` of a cell's limits file."""
    return {k: v["limit"] for k, v in spec.limits.items()}
