"""The import rules: nothing a run loads has the top-level name ``jax``,
``jaxlib``, ``flax``, ``repro`` or ``benchmarks`` (compared whole, so
``repro_torch`` is allowed), and the reference loads nothing of the
program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import BENCH, REPO


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PYTHONPATH": f"{BENCH}:{REPO / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_nor_the_jax_package(tmp_path):
    code = (f"import sys; sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
            "import conftest, pathlib\n"
            f"root = conftest.make_tiny(pathlib.Path({str(tmp_path)!r}))\n"
            "out = conftest.tiny_run(root, 'tiny.moe')\n"
            "assert out['correct']\n"
            "from harness import core\n"
            "assert core.forbidden_modules() == []")
    loaded = _loaded(code)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import reference.model, harness.weights, "
                     "harness.check, roofline.counts")
    assert not loaded & {"repro_torch", "repro", "jax"}
    for path in (BENCH / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "harness", "jax"), (path, n)


def test_forbidden_names_are_compared_whole(monkeypatch):
    from harness import core
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in core.forbidden_modules()
