"""The port's index and routing checkpoints against the reference's: each
package restores the other's index snapshots and routing records to the
same segments and routing, a sharded warren checkpointed by one package
restores in the other, and torn or partial checkpoints are refused.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import DynamicIndex as RefIndex
from repro.core import Warren as RefWarren
from repro.core import index_document as ref_index_document
from repro.dist.checkpoint import CheckpointManager as RefManager
from repro.dist.rebalance import Rebalancer as RefRebalancer
from repro.dist.shard_router import ShardedWarren as RefSharded
from repro_torch.core import DynamicIndex, Warren, index_document
from repro_torch.dist.checkpoint import CheckpointCorrupt, CheckpointManager
from repro_torch.dist.rebalance import Rebalancer
from repro_torch.dist.shard_router import ShardedWarren

VOCAB = ["school", "education", "student", "government", "law", "state",
         "stock", "money", "business", "vibration", "conductor", "wind"]
QUERIES = ["school education student", "stock money business"]


def _text(n: int) -> str:
    return " ".join(VOCAB[(n * 7 + i * (1 + n % 5)) % len(VOCAB)]
                    for i in range(3 + n % 6))


def _ingest(warren, index_doc, ids, batch=16):
    ids = list(ids)
    while ids:
        chunk, ids = ids[:batch], ids[batch:]
        with warren:
            warren.transaction()
            for n in chunk:
                index_doc(warren, _text(n), docid=f"d{n}")
            warren.commit()


def _records(index):
    return [s.to_record() for s in index._segments]


MANAGERS = {"ref": lambda d: RefManager(d, async_write=False),
            "port": CheckpointManager}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_index_snapshot_cross_restore(tmp_path, writer, reader):
    ref, port = RefWarren(RefIndex()), Warren(DynamicIndex())
    _ingest(ref, ref_index_document, range(50))
    _ingest(port, index_document, range(50))
    assert _records(ref.index) == _records(port.index)
    src = {"ref": ref, "port": port}[writer].index
    MANAGERS[writer](str(tmp_path)).save_index(7, src)
    got = MANAGERS[reader](str(tmp_path)).restore_index(7)
    assert _records(got) == _records(src)
    assert (got._next_addr, got._next_seq) == (src._next_addr,
                                               src._next_seq)
    assert MANAGERS[reader](str(tmp_path)).index_steps() == [7]


def test_index_snapshot_bytes_equal(tmp_path):
    """One codec on both sides: the port writes the reference's bytes."""
    ref, port = RefWarren(RefIndex()), Warren(DynamicIndex())
    _ingest(ref, ref_index_document, range(30))
    _ingest(port, index_document, range(30))
    a = RefManager(str(tmp_path / "a"), async_write=False).save_index(
        3, ref.index)
    b = CheckpointManager(str(tmp_path / "b")).save_index(3, port.index)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_restore_index_replicas_fans_out(tmp_path):
    port = Warren(DynamicIndex())
    _ingest(port, index_document, range(20))
    cm = CheckpointManager(str(tmp_path))
    cm.save_index(1, port.index, name="shard00")
    reps = cm.restore_index_replicas(1, name="shard00", n=3)
    assert len(reps) == 3 and reps[0] is not reps[1]
    assert all(_records(r) == _records(port.index) for r in reps)
    with pytest.raises(ValueError, match="per-replica"):
        cm.restore_index_replicas(1, name="shard00", n=2,
                                  log_path=str(tmp_path / "shared.log"))
    with pytest.raises(FileNotFoundError):
        cm.restore_index_replicas(2, name="shard00")


def _sharded_pair(tmp_path, split=True):
    ref = RefSharded(n_shards=2, replicas=2, static_dir=str(tmp_path / "r"))
    port = ShardedWarren(n_shards=2, replicas=2,
                         static_dir=str(tmp_path / "p"))
    _ingest(ref, ref_index_document, range(90))
    _ingest(port, index_document, range(90))
    if split:
        RefRebalancer(ref).split_group(0)
        Rebalancer(port).split_group(0)
    ref.demote_group(1)
    port.demote_group(1)
    return ref, port


def _same_warrens(a, b):
    assert a.routing.to_record() == b.routing.to_record()
    assert [[(i._next_addr, i._next_seq) for i in g.replicas]
            for g in a.groups] == \
        [[(i._next_addr, i._next_seq) for i in g.replicas]
         for g in b.groups]
    with a, b:
        for f in (":", "school", "docid:d5", "docid:d80"):
            x, y = a.annotations(f), b.annotations(f)
            assert np.array_equal(x.starts, y.starts), f
            assert np.array_equal(x.values, y.values), f
        for q in QUERIES:
            assert a.search(q, k=10) == b.search(q, k=10)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_sharded_checkpoint_cross_restore(tmp_path, writer):
    """A split, partly demoted warren checkpointed by one package restores
    in the other: routing record, epochs, floors and lists equal."""
    ref, port = _sharded_pair(tmp_path)
    src = {"ref": ref, "port": port}[writer]
    cm_dir = str(tmp_path / "ck")
    src.checkpoint(MANAGERS[writer](cm_dir), 5)
    routing = json.load(open(os.path.join(cm_dir,
                                          "routing_00000005.routing.json")))
    assert routing["routing"]["table"] == port.routing.to_record()
    back_ref = RefSharded.restore(RefManager(cm_dir, async_write=False), 5,
                                  replicas=2)
    back_port = ShardedWarren.restore(CheckpointManager(cm_dir), 5,
                                      replicas=2)
    _same_warrens(back_ref, back_port)
    _same_warrens(back_port, port)
    assert [g.epoch for g in back_port.groups] == [g.epoch
                                                    for g in port.groups]


def test_routing_record_torn_or_missing(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    assert cm.restore_routing(4) is None
    path = cm.save_routing(4, {"table": {"x": 1}, "groups": []})
    assert RefManager(str(tmp_path), async_write=False).restore_routing(
        4) == cm.restore_routing(4) == {"table": {"x": 1}, "groups": []}
    with open(path, "r+") as fh:
        body = fh.read()
        fh.seek(0)
        fh.write(body.replace('"x": 1', '"x": 2'))
    with pytest.raises(CheckpointCorrupt, match="crc"):
        cm.restore_routing(4)
    with open(path, "w") as fh:
        fh.write('{"crc": 1, "routing": ')
    with pytest.raises(CheckpointCorrupt):
        cm.restore_routing(4)


def test_missing_shard_snapshot_is_refused(tmp_path):
    _, port = _sharded_pair(tmp_path, split=False)
    cm = CheckpointManager(str(tmp_path / "ck"))
    port.checkpoint(cm, 2)
    os.unlink(os.path.join(cm.directory, "shard01_00000002.log"))
    with pytest.raises(CheckpointCorrupt, match="missing"):
        ShardedWarren.restore(cm, 2)


def test_torn_writes_are_cleared_at_open(tmp_path):
    (tmp_path / "index_00000001.log.tmp-123").write_bytes(b"torn")
    (tmp_path / "step_00000002.tmp-9").mkdir()
    cm = CheckpointManager(str(tmp_path))
    assert os.listdir(cm.directory) == []
    assert cm.all_steps() == [] and cm.latest_step() is None
