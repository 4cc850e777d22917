"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files under ``paths``, and every cell, metric and mix found by name."""

from __future__ import annotations

import json
import re

from conftest import BENCH, REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "e2e": {"name", "unit", "better", "bound", "source", "workloads"},
        "layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"]), w


def test_names_units_and_keys():
    seen = set()
    for kind, entries in (("config", MAN["configs"]),
                          ("workload", MAN["workloads"]),
                          ("e2e", MAN["end_to_end"]),
                          ("layer", MAN["per_layer"])):
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names))
        for e in entries:
            assert set(e) <= KEYS[kind], (kind, set(e) - KEYS[kind])
            assert NAME.match(e["name"]), e["name"]
            if kind in ("e2e", "layer"):
                assert e["name"] not in seen
                seen.add(e["name"])
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES
            if "why" in e:
                assert _line(e["why"])
    assert 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128


def test_configs_are_files_of_their_own_and_used():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    widths = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                        r"proj|head_dim|_dim$|_rank$|experts_per_tok|expan)")
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not widths.search(key), key
        assert _line(c["source"])


def test_cells_find_their_files_and_report_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    pairs = set()
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    from harness import manifest
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = manifest.mix(w["traffic"])
        assert (BENCH / "drivers" / f"{mix['kind']}.py").exists()
        assert _line(mix["source"]), w["traffic"]
        assert manifest.limits(w["name"]), w["name"]
        reported = {m["name"] for m in manifest.end_to_end(MAN, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        for m in manifest.per_layer(MAN, w["name"]):
            assert m["moves"] in reported
        assert manifest.per_layer(MAN, w["name"])


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(REPO).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_limits_hold_their_readings():
    """Each limit lies above the lower reading it was set from and below
    the upper one."""
    from harness import manifest
    for w in MAN["workloads"]:
        for name, lim in manifest.limits(w["name"]).items():
            assert lim["lower"] < lim["limit"] < lim["upper"], (w, name)
