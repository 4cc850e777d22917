"""A configuration, a traffic mix, a per-layer metric and a cell are
added by adding files and entries alone: in a copy, the additions run
and report, and no file that was there changed."""

from __future__ import annotations

import hashlib
import json

from conftest import make_tiny, tiny_run


def _digests(root) -> dict:
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_add_config_mix_metric_and_cell_by_files_alone(tmp_path):
    root = make_tiny(tmp_path / "copy")
    before = _digests(root)
    b = root / "bench"
    cfg = json.loads((b / "configs" / "tiny-dense.json").read_text())
    cfg.update(name="tiny-dense-3l", num_hidden_layers=3)
    (b / "configs" / "tiny-dense-3l.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "tiny_prefill.json").read_text())
    mix.update(batch=2, prompt_tokens=64)
    (b / "traffic" / "tiny_prefill_x2.json").write_text(json.dumps(mix))
    (b / "metrics" / "calls_done.prefill.py").write_text(
        "def read(run):\n"
        "    w = run['window']\n"
        "    return float(w['calls']) if w['kind'] == 'prefill' else None\n")
    limits = json.loads((b / "limits" / "tiny.prefill.json").read_text())
    (b / "limits" / "tiny.added.json").write_text(json.dumps(limits))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-dense-3l", "source": "tiny",
                           "file": "bench/configs/tiny-dense-3l.json",
                           "reduced": [], "why": "tiny"})
    man["workloads"].append({"name": "tiny.added", "config": "tiny-dense-3l",
                             "traffic": "tiny_prefill_x2", "chips": 1,
                             "why": "tiny"})
    for m in man["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append("tiny.added")
    man["per_layer"].append({"name": "calls_done.prefill", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "server loop",
                             "moves": "prefill_tokens_per_s",
                             "workloads": ["tiny.added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}
    out = tiny_run(root, "tiny.added")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    from harness import manifest
    names = [m["name"] for m in manifest.per_layer(man, "tiny.added")]
    assert "calls_done.prefill" in names
    record = {"window": {"kind": "prefill", "calls": 3}}
    assert manifest.reader("calls_done.prefill", b)(record) == 3.0
