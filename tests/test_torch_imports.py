"""Import hygiene: the port and chip_smoke.py never touch JAX or the
reference package, at import time or in their source."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_or_reference():
    mods = _modules()
    assert {"repro_torch.serve", "repro_torch.models.transformer",
            "repro_torch.models.layers", "repro_torch.configs.lm_family",
            "repro_torch.kernels.gqa_decode.kernel",
            "repro_torch.models.recsys", "repro_torch.configs.recsys_family",
            "repro_torch.kernels.embedding_bag.kernel"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _foreign(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
