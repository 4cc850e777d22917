"""Everything a run finds by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``bench/traffic/<mix>.json``;
the mix's ``kind`` names its driver, ``bench/drivers/<kind>.py``.  Each
metric is read by ``bench/metrics/<metric>.py``, and each cell's limits
of ``correct`` are in ``bench/limits/<cell>.json``.  A configuration, a
mix, a metric or a cell is added by adding files and entries: nothing
here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, workload: str) -> dict:
    for c in man["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(root: Path, man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def limits(name: str, bench: Path = BENCH) -> dict:
    path = bench / "limits" / f"{name}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def end_to_end(man: dict, workload: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in man["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(man: dict, workload: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(man, workload)}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path = BENCH):
    """``read(run)`` of ``bench/metrics/<metric>.py``."""
    return _module(bench / "metrics" / f"{metric}.py",
                   "bench_metric_" + metric.replace(".", "_")).read


def driver(kind: str, bench: Path = BENCH):
    """The ``Driver`` class of ``bench/drivers/<kind>.py``."""
    return _module(bench / "drivers" / f"{kind}.py",
                   "bench_driver_" + kind).Driver
