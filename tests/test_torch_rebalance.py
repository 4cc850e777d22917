"""The port's Rebalancer against the reference's: the same split or merge
on the same warren leaves the same routing table, group floors and
annotation lists (addresses and values bit for bit), hot or demoted; and
the port's split completes under concurrent writers and readers.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import index_document as ref_index_document
from repro.dist.rebalance import Rebalancer as RefRebalancer
from repro.dist.shard_router import ShardedWarren as RefSharded
from repro_torch.core import DynamicIndex, Warren, index_document, score_bm25
from repro_torch.dist.rebalance import (RebalanceError, RebalanceStats,
                                        Rebalancer)
from repro_torch.dist.shard_router import ShardedWarren

VOCAB = ["school", "education", "student", "government", "law", "state",
         "stock", "money", "business", "vibration", "conductor", "wind"]
QUERIES = ["school education student", "government law state",
           "stock money business", "vibration conductor wind"]
JOIN_S = 120


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


def _erase(warren, docid):
    with warren:
        lst = warren.annotations("docid:" + docid)
        warren.transaction()
        warren.erase(int(lst.starts[0]), int(lst.ends[0]))
        warren.commit()


def _both(n_docs=120, n_shards=2, replicas=2, **kw):
    """The same warren built by each package: (reference, port)."""
    out = []
    for cls, index_doc, sub in ((RefSharded, ref_index_document, "ref"),
                                (ShardedWarren, index_document, "port")):
        extra = {k: os.path.join(v, sub) for k, v in kw.items()}
        w = cls(n_shards=n_shards, replicas=replicas, **extra)
        _ingest(w, index_doc, range(n_docs))
        out.append(w)
    return out


def _routing(w) -> dict:
    r = w.describe_routing()
    for g in r["groups"].values():
        g["demoted"] = g["demoted"] is not None
    return r


def _assert_same(ref, port, features=(":", "school", "docid:d10")):
    assert _routing(ref) == _routing(port)
    assert [[(i._next_addr, i._next_seq) for i in g.replicas]
            for g in ref.groups] == \
        [[(i._next_addr, i._next_seq) for i in g.replicas]
         for g in port.groups]
    with ref, port:
        for f in features:
            a, b = ref.annotations(f), port.annotations(f)
            assert np.array_equal(a.starts, b.starts), f
            assert np.array_equal(a.ends, b.ends), f
            assert np.array_equal(a.values, b.values), f
        for q in QUERIES:
            assert ref.search(q, k=10) == port.search(q, k=10), q


def _stats_shape(s: RebalanceStats):
    return (s.kind, s.source, s.dest, s.epoch, s.freeze_seq, s.pivot,
            s.segments_streamed, s.catchup_rounds)


def test_split_matches_reference():
    ref, port = _both()
    for w in (ref, port):
        for d in ("d3", "d40"):
            _erase(w, d)
    rbs = RefRebalancer(ref), Rebalancer(port)
    assert rbs[0].split_group(0) == rbs[1].split_group(0) == 2
    assert _stats_shape(rbs[0].last_stats) == _stats_shape(rbs[1].last_stats)
    _ingest(ref, ref_index_document, range(500, 540))
    _ingest(port, index_document, range(500, 540))
    _assert_same(ref, port, (":", "docid:d3", "docid:d80", "docid:d510"))


@pytest.mark.parametrize("pivot_doc", [None, 30, 100])
def test_split_at_pivot_matches_reference(pivot_doc):
    ref, port = _both(n_docs=110)
    pivot, owner = None, 0
    if pivot_doc is not None:            # the start of a document
        with port:
            pivot = int(port.annotations(f"docid:d{pivot_doc}").starts[0])
        owner = port.routing.owner(pivot)
    new = [RefRebalancer(ref).split_group(owner, pivot),
           Rebalancer(port).split_group(owner, pivot)]
    assert new[0] == new[1]
    _assert_same(ref, port)


def test_split_then_merge_matches_reference():
    ref, port = _both(n_docs=100)
    rbs = RefRebalancer(ref), Rebalancer(port)
    gid = [rb.split_group(0) for rb in rbs]
    assert gid[0] == gid[1]
    _ingest(ref, ref_index_document, range(700, 720))
    _ingest(port, index_document, range(700, 720))
    for rb in rbs:
        rb.merge_groups(0, gid[1])
    assert _stats_shape(rbs[0].last_stats) == _stats_shape(rbs[1].last_stats)
    assert port.groups[gid[1]].retired
    with pytest.raises(RebalanceError, match="retired"):
        rbs[1].split_group(gid[1])
    _ingest(ref, ref_index_document, range(800, 830))
    _ingest(port, index_document, range(800, 830))
    _assert_same(ref, port, (":", "docid:d0", "docid:d705", "docid:d820"))


def test_split_group_async_matches_sync():
    _, a = _both(n_docs=80)
    _, b = _both(n_docs=80)
    fut = Rebalancer(a).split_group_async(0)
    assert fut.result(timeout=60) == Rebalancer(b).split_group(0)
    _assert_same(a, b)


@pytest.mark.parametrize("op", ["split", "merge"])
def test_demoted_rebalance_matches_reference(tmp_path, op):
    """A cold group split or merged by shipping its run sets: the same
    routing and lists as the reference's, the groups never promoted."""
    ref, port = _both(n_docs=90, n_shards=3, static_dir=str(tmp_path))
    for w in (ref, port):
        w.demote_group(0)
        if op == "merge":
            w.demote_group(1)
    rbs = RefRebalancer(ref), Rebalancer(port)
    if op == "split":
        assert rbs[0].split_group(0) == rbs[1].split_group(0)
    else:
        for rb in rbs:
            rb.merge_groups(0, 1)
        assert rbs[1].last_stats.kind == "merge-demoted"
    assert [d is not None for d in port.demoted()] == \
        [d is not None for d in ref.demoted()]
    assert port.demoted()[0] is not None
    _assert_same(ref, port)


def test_split_with_concurrent_writers_and_readers():
    """The port's live split under 3 writers and 2 readers: no aborted
    reader, no writer error, every thread done within its timeout, and
    the result scores as a single index of the committed documents."""
    sharded = ShardedWarren(n_shards=2, replicas=2)
    _ingest(sharded, index_document, range(80))
    errors, committed = [], []
    stop = threading.Event()

    def writer(wid):
        wc = sharded.clone()
        for i in range(30):
            n = 1000 + wid * 100 + i
            try:
                with wc:
                    wc.transaction()
                    index_document(wc, _text(n), docid=f"d{n}")
                    wc.commit()
                committed.append(n)
            except Exception as e:            # noqa: BLE001
                errors.append(f"writer d{n}: {type(e).__name__}: {e}")
                return

    def reader():
        wc = sharded.clone()
        seen = 0
        while not stop.is_set():
            try:
                with wc:
                    n = len(wc.annotations(":"))
                    wc.search("school education", k=5)
                if n < seen:
                    errors.append(f"reader went backwards: {n} < {seen}")
                    return
                seen = n
            except Exception as e:            # noqa: BLE001
                errors.append(f"reader: {type(e).__name__}: {e}")
                return

    writers = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(3)]
    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(2)]
    for t in writers + readers:
        t.start()
    rb = Rebalancer(sharded)
    new_gid = rb.split_group(0)
    for t in writers:
        t.join(timeout=JOIN_S)
    stop.set()
    for t in readers:
        t.join(timeout=JOIN_S)
    hung = [t.name for t in writers + readers if t.is_alive()]
    assert not hung, f"threads still running: {hung}"
    assert errors == [], errors
    assert len(committed) == 90 and new_gid == 2
    assert rb.last_stats.swap_s > 0.0
    single = Warren(DynamicIndex())
    _ingest(single, index_document, range(80))
    _ingest(single, index_document, sorted(committed), batch=1)
    with sharded, single:
        assert len(sharded.annotations(":")) == 80 + len(committed)
        for q in QUERIES:
            got = sorted(s for _, s in sharded.search(q, k=10))
            want = sorted(s for _, s in score_bm25(single, q, k=10))
            np.testing.assert_allclose(got, want, rtol=1e-9)
