"""Import hygiene: the port and chip_smoke.py never touch JAX, the
reference package or ``msgpack``, at import time or in their source; and
the port's durable formats work with ``msgpack`` and ``zstandard`` absent,
as on a machine that has neither."""

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
    return top in ("jax", "jaxlib", "repro", "msgpack")


def test_importing_every_module_loads_no_jax_or_reference():
    mods = _modules()
    assert {"repro_torch.serve", "repro_torch.models.transformer",
            "repro_torch.models.layers", "repro_torch.configs.lm_family",
            "repro_torch.kernels.gqa_decode.kernel",
            "repro_torch.models.recsys", "repro_torch.configs.recsys_family",
            "repro_torch.kernels.embedding_bag.kernel",
            "repro_torch.core.packing", "repro_torch.core.faults",
            "repro_torch.core.runfile", "repro_torch.core.static",
            "repro_torch.dist", "repro_torch.dist.parallel",
            "repro_torch.dist.shard_router", "repro_torch.dist.rebalance",
            "repro_torch.dist.checkpoint", "repro_torch.tiered",
            "repro_torch.tiered.manifest", "repro_torch.tiered.cache",
            "repro_torch.tiered.compaction",
            "repro_torch.tiered.store", "repro_torch.train",
            "repro_torch.train.optimizer", "repro_torch.train.trainer",
            "repro_torch.dist.compression", "repro_torch.data.pipeline",
            "repro_torch.launch.train",
            "repro_torch.kernels.embedding_bag.ops",
            "repro_torch.models.nequip", "repro_torch.configs.gnn_family",
            "repro_torch.data.synth", "repro_torch.configs.base",
            "repro_torch.configs.registry",
            "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.dist.sharding", "repro_torch.dist.elastic",
            "repro_torch.dist.on_mesh", "repro_torch.obs",
            "repro_torch.obs.metrics", "repro_torch.obs.registry",
            "repro_torch.obs.trace", "repro_torch.obs.rotate",
            "repro_torch.obs.slo", "repro_torch.obs.profile",
            "repro_torch.obs.witness", "repro_torch.obs.hierarchy",
            "repro_torch.obs.server", "repro_torch.obs.timeline",
            "repro_torch.dist.autopilot", "repro_torch.dist.simharness",
            "repro_torch.core.sparse", "repro_torch.core.graph_store"} \
        <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
            "import torch.distributed as dist\n"
            "if dist.is_available() and dist.is_initialized():\n"
            "    bad.append('a process group')\n"
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


_BLOCKED = """
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("msgpack", "zstandard"):
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
"""

_DURABLE = """
import os
import sys
import tempfile

from repro_torch.core import (DynamicIndex, StaticIndex, Warren,
                              ingest_documents, write_run)
from repro_torch.core.log import TransactionLog
from repro_torch.data.synth import doc_generator
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.shard_router import ShardedWarren
from repro_torch.tiered import TieredStore

assert "msgpack" not in sys.modules and "zstandard" not in sys.modules
d = tempfile.mkdtemp()
w = Warren(DynamicIndex(log_path=os.path.join(d, "wal.log")))
ingest_documents(w, doc_generator(1, 30), batch=10)
w.index._log.close()
back = DynamicIndex.recover(os.path.join(d, "wal.log"))
assert [s.to_record() for s in back._segments] == \\
    [s.to_record() for s in w.index._segments]
assert sum(r["t"] == "commit"
           for r in TransactionLog(os.path.join(d, "wal.log")).replay()) == 3
write_run(w.index._segments, os.path.join(d, "run"))
si = StaticIndex(os.path.join(d, "run"))
fv = w.index.featurizer.featurize(":")
with w:
    assert list(si.annotations(fv).starts) == \\
        list(w.annotations(":").starts)
si.close()
os.makedirs(os.path.join(d, "wals"))
sh = ShardedWarren(n_shards=2, replicas=2, log_dir=os.path.join(d, "wals"),
                   static_dir=os.path.join(d, "static"))
ingest_documents(sh, doc_generator(2, 40), batch=8)
sh.demote_group(0)
cm = CheckpointManager(os.path.join(d, "ck"))
sh.checkpoint(cm, 1)
again = ShardedWarren.restore(cm, 1, replicas=2)
with sh, again:
    assert list(sh.annotations(":").starts) == \\
        list(again.annotations(":").starts)
store = TieredStore(os.path.join(d, "tiered"))
ingest_documents(store.warren(), doc_generator(3, 20), batch=5)
store.freeze()
store.close()
reopened = TieredStore(os.path.join(d, "tiered"))
tw = reopened.warren()
with tw:
    assert len(tw.annotations(":")) == 20
reopened.close()
import torch
cm.save(5, {"w": torch.ones(3, dtype=torch.bfloat16), "step": 5},
        block=True)
got = cm.restore(5, {"w": torch.zeros(3, dtype=torch.bfloat16), "step": 0})
assert got["step"] == 5 and got["w"].tolist() == [1.0, 1.0, 1.0]
print("ok")
"""


def test_durable_formats_without_msgpack_or_zstandard():
    """With ``msgpack`` and ``zstandard`` blocked on ``sys.meta_path``:
    every module imports, and a WAL, a static run, replica WALs, a demoted
    group, an index checkpoint, a tiered run set and a train-state
    checkpoint with a bfloat16 leaf are written and read back."""
    mods = _modules()
    code = (_BLOCKED + f"for m in {mods!r}:\n    __import__(m)\n"
            + _DURABLE)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
