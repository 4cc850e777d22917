"""The port's ShardedWarren against the reference's, op for op.

The same logical operations go into ``repro.dist.shard_router`` and
``repro_torch.dist.shard_router`` warrens of 3 groups × 2 replicas: the
routing tables, every replica's address and sequence floors, the
annotation lists (addresses and values bit for bit) and ``search`` must
be equal after every step — through failover, resurrection, quorum
aborts and replica WALs.  Both packages are deterministic, so addresses
agree exactly, unlike a sharded warren against a single index.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro.core import DynamicIndex as RefIndex
from repro.core import Warren as RefWarren
from repro.core import index_document as ref_index_document
from repro.core import score_bm25 as ref_score_bm25
from repro.core.log import TransactionLog as RefLog
from repro.dist.shard_router import ShardedWarren as RefSharded
from repro_torch.core import index_document
from repro_torch.core.log import TransactionLog
from repro_torch.dist.shard_router import (QuorumError, ReplicaFailure,
                                           ShardedWarren, shard_of)

VOCAB = ["school", "education", "student", "government", "law", "state",
         "stock", "money", "business", "vibration", "conductor", "wind"]
QUERIES = ["school education student", "government law state",
           "stock money business", "vibration conductor wind"]


def _doc_text(n: int) -> str:
    words = [VOCAB[(n * 7 + i * (1 + n % 5)) % len(VOCAB)]
             for i in range(3 + n % 6)]
    return " ".join(words)


def _run_ops(warren, ops, index_doc):
    """The reference replication test's op interpreter: appends, annotates
    and erases staged per transaction, then committed or aborted."""
    committed, staged, tags, next_doc = [], [], set(), [0]

    def flush(commit: bool):
        if not staged:
            return
        batch, staged[:] = list(staged), []
        with warren:
            warren.transaction()
            appended, erased = [], []
            for op in batch:
                if op[0] == "append":
                    n = next_doc[0]
                    next_doc[0] += 1
                    index_doc(warren, _doc_text(n), docid=f"d{n}")
                    appended.append(f"d{n}")
                    continue
                live = ([d for d in committed if d not in erased]
                        if op[0] == "erase" else committed)
                if not live:
                    continue
                docid = live[op[1] % len(live)]
                lst = warren.annotations("docid:" + docid)
                if not len(lst):
                    continue
                if op[0] == "annotate":
                    tag = f"tag{op[1] % 4}:"
                    tags.add(tag)
                    warren.annotate(tag, int(lst.starts[0]),
                                    int(lst.ends[0]), float(op[1] % 7))
                else:
                    warren.erase(int(lst.starts[0]), int(lst.ends[0]))
                    erased.append(docid)
            if commit:
                warren.commit()
                committed.extend(appended)
                for d in erased:
                    committed.remove(d)
            else:
                warren.abort()
                next_doc[0] -= len(appended)

    for op in ops:
        if op[0] in ("commit", "abort"):
            flush(op[0] == "commit")
        else:
            staged.append(op)
    flush(True)
    return committed, tags


def _ingest(warren, index_doc, n_docs, start=0, batch=32):
    n = start
    while n < start + n_docs:
        with warren:
            warren.transaction()
            for _ in range(min(batch, start + n_docs - n)):
                index_doc(warren, _doc_text(n), docid=f"d{n}")
                n += 1
            warren.commit()


def _routing(w) -> dict:
    """``describe_routing`` with demotion directories as flags (the two
    warrens demote into different directories)."""
    r = w.describe_routing()
    for g in r["groups"].values():
        g["demoted"] = g["demoted"] is not None
    return r


def _floors(w):
    return [[(idx._next_addr, idx._next_seq) for idx in g.replicas]
            for g in w.groups]


def _assert_same(ref, port, features, queries=QUERIES):
    """Equal routing, floors, lists (bit for bit) and search results."""
    assert _routing(ref) == _routing(port)
    assert _floors(ref) == _floors(port)
    with ref, port:
        for f in features:
            a, b = ref.annotations(f), port.annotations(f)
            assert np.array_equal(a.starts, b.starts), f
            assert np.array_equal(a.ends, b.ends), f
            assert np.array_equal(a.values, b.values), f
        for q in queries:
            assert ref.search(q, k=10) == port.search(q, k=10), q
        docs = ref.annotations(":")
        for s, e in list(zip(docs.starts, docs.ends))[:20]:
            assert ref.translate(int(s), int(e)) == \
                port.translate(int(s), int(e))


OPS = st.lists(
    st.tuples(st.sampled_from(["append", "append", "annotate", "erase",
                               "commit", "abort"]),
              st.integers(0, 999)),
    min_size=6, max_size=40)


@settings(database=None, derandomize=True, deadline=None, max_examples=8)
@given(OPS)
def test_same_ops_same_routing_and_lists_property(ops):
    ref = RefSharded(n_shards=3, replicas=2)
    port = ShardedWarren(n_shards=3, replicas=2)
    got_ref = _run_ops(ref, ops, ref_index_document)
    got_port = _run_ops(port, ops, index_document)
    assert got_ref == got_port
    docs, tags = got_port
    _assert_same(ref, port,
                 [":", "school", "wind"] + sorted(tags)
                 + [f"docid:{d}" for d in docs])


@pytest.fixture(scope="module")
def pair():
    ref = RefSharded(n_shards=3, replicas=2)
    port = ShardedWarren(n_shards=3, replicas=2)
    _ingest(ref, ref_index_document, 150)
    _ingest(port, index_document, 150)
    return ref, port


FEATURES = [":", "school", "money", "docid:d0", "docid:d149"]


def test_ingest_same_addresses(pair):
    ref, port = pair
    _assert_same(ref, port, FEATURES)
    assert ref.group_doc_counts() == port.group_doc_counts()
    assert ref.group_seqnums() == port.group_seqnums()
    with port:
        starts = port.annotations(":").starts
    assert len({shard_of(int(s)) for s in starts}) == 3


@pytest.mark.parametrize("async_scatter", [False, True])
def test_search_and_gcl_match(pair, async_scatter):
    ref, port = pair
    for w in pair:
        w.set_async_scatter(async_scatter)
    try:
        with ref, port:
            for q in QUERIES:
                assert ref.search(q, k=10) == port.search(q, k=10)
            for q in ('"school education"', "school"):
                assert ref.search_gcl(q, limit=5000) == \
                    port.search_gcl(q, limit=5000)
            a, b = ref.global_stats(), port.global_stats()
            assert (a.n_docs, a.avgdl) == (b.n_docs, b.avgdl)
            assert np.array_equal(a.doc_starts, b.doc_starts)
    finally:
        for w in pair:
            w.set_async_scatter(False)


def test_search_tie_at_k_boundary():
    """The reference serving test's tie across groups at the k boundary:
    both packages keep the same members (same addresses, same order)."""
    docs = [(f"hi{i}", "school school education education") for i in range(3)]
    docs += [(f"tie{i}", f"school education filler{i}") for i in range(14)]
    docs += [(f"noise{i}", "stock money business") for i in range(6)]
    out = []
    for cls, index_doc in ((RefSharded, ref_index_document),
                           (ShardedWarren, index_document)):
        w = cls(n_shards=3)
        for docid, text in docs:
            with w:
                w.transaction()
                index_doc(w, text, docid=docid)
                w.commit()
        with w:
            out.append(w.search("school education", k=10))
    assert out[0] == out[1]
    assert len(out[1]) == 10


def test_failover_then_resurrect_match(pair):
    """One replica of every group dead: both packages answer as before.
    Then, as in the reference's replication test, writes while group 1's
    replica 0 is dead, and its resurrection: lockstep on both packages,
    and the same state."""
    ref, port = pair
    with port:
        before = {q: port.search(q, k=10) for q in QUERIES}
    for w in pair:
        for g in range(w.n_shards):
            w.mark_failed(g, g % 2)
    assert ref.health() == port.health()
    with ref, port:
        for q in QUERIES:
            assert port.search(q, k=10) == before[q] == ref.search(q, k=10)
    for w in pair:
        for g in range(w.n_shards):
            w.resurrect(g, g % 2)
        w.mark_failed(1, 0)
    _ingest(ref, ref_index_document, 20)
    _ingest(port, index_document, 20)
    assert ref.group_seqnums() == port.group_seqnums()
    for w in pair:
        w.resurrect(1, 0)
    assert all(all(h) for h in port.health())
    for grp in port.groups:
        a, b = grp.replicas
        assert (a._next_addr, a._next_seq) == (b._next_addr, b._next_seq)
        assert [s.seqnum for s in a._segments] == \
            [s.seqnum for s in b._segments]
    _assert_same(ref, port, FEATURES)


def test_quorum_abort_is_clean_on_both(pair):
    """A replica down below quorum in group 0: the cross-shard transaction
    aborts whole on both packages, and the retry commits the same."""
    ref, port = pair
    with port:
        docs = port.annotations(":")
        picks = [(int(docs.starts[i]), int(docs.ends[i]))
                 for i in range(0, len(docs), max(len(docs) // 5, 1))]
    assert len({shard_of(p) for p, _ in picks}) > 1
    errors = {}
    for w in pair:
        w.mark_failed(0, 0)
        try:
            with w:
                w.transaction()
                for p, q in picks:
                    w.annotate("qtag:", p, q, 1.0)
                with pytest.raises(Exception) as exc:
                    w.commit()
                errors[w is port] = exc.value
        finally:
            w.resurrect(0, 0)
    assert isinstance(errors[True], QuorumError)
    assert type(errors[False]).__name__ == "QuorumError"
    _assert_same(ref, port, FEATURES + ["qtag:"])
    for w in pair:
        with w:
            assert len(w.annotations("qtag:")) == 0
            w.transaction()
            for p, q in picks:
                w.annotate("qtag:", p, q, 1.0)
            w.commit()
    _assert_same(ref, port, FEATURES + ["qtag:"])


def test_all_replicas_dead_raises_replica_failure():
    port = ShardedWarren(n_shards=3, replicas=2)
    _ingest(port, index_document, 40)
    port.mark_failed(2, 0)
    port.mark_failed(2, 1)
    with pytest.raises(ReplicaFailure):
        with port:
            pass
    port.groups[2].alive[0] = True
    port.resurrect(2, 1)
    with port:
        assert len(port.annotations(":")) == 40


def test_replica_wals_cross_read(tmp_path):
    """Each replica logs to its own WAL; each package replays the other's
    WAL files to the same records, and recovers the same index."""
    dirs = {}
    for name, cls, index_doc in (("ref", RefSharded, ref_index_document),
                                 ("port", ShardedWarren, index_document)):
        d = tmp_path / name
        d.mkdir()
        w = cls(n_shards=3, replicas=2, log_dir=str(d))
        _ingest(w, index_doc, 60, batch=16)
        w.close()
        dirs[name] = d
    names = sorted(os.listdir(dirs["ref"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 6
    from repro.core import DynamicIndex as RefDI
    from repro_torch.core import DynamicIndex
    for fn in names:
        ref_path, port_path = str(dirs["ref"] / fn), str(dirs["port"] / fn)
        assert list(RefLog(port_path).replay()) == \
            list(TransactionLog(ref_path).replay())
        assert list(TransactionLog(port_path).replay()) == \
            list(RefLog(ref_path).replay())
        a = RefDI.recover(port_path)
        b = DynamicIndex.recover(ref_path)
        assert [s.to_record() for s in a._segments] == \
            [s.to_record() for s in b._segments]


def test_sharded_search_matches_single_index():
    """Against one DynamicIndex holding the same documents: the same
    scores, and the same texts up to ties (addresses differ by design)."""
    port = ShardedWarren(n_shards=3, replicas=2)
    single = RefWarren(RefIndex())
    _ingest(port, index_document, 120)
    _ingest(single, ref_index_document, 120)
    with port, single:
        for q in QUERIES:
            got = port.search(q, k=10)
            want = ref_score_bm25(single, q, k=10)
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], rtol=1e-9)


def test_chip_smoke_sharded_and_tiered_phases_on_cpu():
    """``chip_smoke.py``'s phases ``sharded`` and ``tiered`` at a small
    size on the host: every step's checks hold (host against host here;
    the card run holds the card against the host)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.serve import RetrievalServer
    n_docs, n_queries = 600, 32
    single = Warren(DynamicIndex())
    ingest_documents(single, doc_generator(chip_smoke.SEED, n_docs),
                     batch=256)
    queries = chip_smoke.make_queries(chip_smoke.SEED, n_queries)
    server = RetrievalServer(single, k=10, device="cpu")
    try:
        rows, _ = chip_smoke.serve_closed_loop(server, queries, 4)
    finally:
        server.close()
    out = chip_smoke.phase_sharded("cpu", single, queries, rows,
                                   n_docs=n_docs, step_queries=8,
                                   profile=False)
    assert out["vs_single"]["queries"] == n_queries
    assert out["swap_s"] >= 0
    tiered = chip_smoke.phase_tiered("cpu", n_docs=250, every=50,
                                     n_queries=16)
    assert tiered["runs_served"] == 4 and tiered["hot_segments"] > 0
    assert [r["identical"] for r in tiered["rounds"]] == [16, 16]
