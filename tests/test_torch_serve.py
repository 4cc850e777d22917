"""The port's RetrievalServer against the reference server, same index.

The reference index is built with the reference package, its committed
segments are carried across with ``index_from_records``, and both servers
answer from the same state at the same addresses: results must be
identical — addresses, float32 scores bit for bit, and tie order.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import threading

import pytest

torch = pytest.importorskip("torch")

from repro.core import DynamicIndex as RefIndex
from repro.core import Warren as RefWarren
from repro.core import ingest_documents as ref_ingest
from repro.data.synth import doc_generator
from repro.train.serve import RetrievalServer as RefServer
from repro_torch import obs
from repro_torch.convert import index_from_records
from repro_torch.core import Warren, index_document
from repro_torch.serve import BatcherConfig, MicroBatcher, RetrievalServer

QUERIES = ["school education student", "government law state",
           "stock money business", "vibration conductor wind",
           "time", "nothingmatches", "wind wind conductor",
           "people way day man thing woman life child world"]


def _carry(ref_warren):
    return Warren(index_from_records(
        [s.to_record() for s in ref_warren.index._segments]))


@pytest.fixture(scope="module")
def ref_warren():
    w = RefWarren(RefIndex())
    ref_ingest(w, doc_generator(7, 200, mean_len=40), batch=16)
    return w


def _serve_all(server, queries):
    """Submit every query before collecting, so they share micro-batches."""
    handles = [server.batcher.submit(q) for q in queries]
    return [h.get(timeout=60) for h in handles]


@pytest.mark.parametrize("max_postings", [4096, 8])
def test_server_matches_reference(ref_warren, max_postings):
    """A mixed batch, duplicates included; with max_postings=8 the
    per-term cap binds for every common term."""
    queries = QUERIES + QUERIES[:3]
    ref = RefServer(ref_warren, k=10, max_postings=max_postings)
    port = RetrievalServer(_carry(ref_warren), k=10,
                           max_postings=max_postings, device="cpu")
    try:
        want = _serve_all(ref, queries)
        got = _serve_all(port, queries)
        one_by_one = [port.query(q, timeout=60) for q in queries]
    finally:
        ref.close()
        port.close()
    assert got == want
    assert one_by_one == want
    assert any(len(r) == 10 for r in want)
    assert want[QUERIES.index("nothingmatches")] == []


def test_server_k_and_term_cap_match_reference(ref_warren):
    queries = QUERIES[-1:] + QUERIES[:2]
    ref = RefServer(ref_warren, k=3, max_terms=2)
    port = RetrievalServer(_carry(ref_warren), k=3, max_terms=2,
                           device="cpu")
    try:
        assert _serve_all(port, queries) == _serve_all(ref, queries)
    finally:
        ref.close()
        port.close()


def test_server_empty_index():
    ref_w = RefWarren(RefIndex())
    ref = RefServer(ref_w, k=5)
    port = RetrievalServer(_carry(ref_w), k=5, device="cpu")
    try:
        assert _serve_all(port, QUERIES[:3]) == _serve_all(ref, QUERIES[:3])
        assert port.query("school", timeout=30) == []
    finally:
        ref.close()
        port.close()


def test_refresh_stats_sees_new_commits(ref_warren):
    w = _carry(ref_warren)
    port = RetrievalServer(w, k=5, device="cpu")
    try:
        with w:
            w.transaction()
            index_document(w, "xylophone quartz unique", docid="fresh")
            w.commit()
        assert port.query("xylophone", timeout=30) == []   # stale stats
        port.refresh_stats()
        hits = port.query("xylophone", timeout=30)
        assert len(hits) == 1
    finally:
        port.close()


def test_server_records_spans_and_timings(ref_warren):
    port = RetrievalServer(_carry(ref_warren), k=5, device="cpu")
    tr = obs.tracer()
    tr.reset()
    try:
        port.query(QUERIES[0], timeout=30)
    finally:
        port.close()
    names = tr.traces()[-1].names()
    assert names == ["serve.batch", "device_score", "merge"]
    assert port.timings.snapshot()["queries"] == 1
    assert "ms/query" in port.timing_summary()


def test_microbatcher_survives_handler_exception():
    def handler(batch):
        if any(req == "poison" for req in batch):
            raise ValueError("bad batch")
        return [req.upper() for req in batch]

    mb = MicroBatcher(handler, BatcherConfig(max_batch=1, max_wait_ms=0.5))
    try:
        assert mb.submit("first").get(timeout=5) == "FIRST"
        poisoned = mb.submit("poison")
        with pytest.raises(ValueError, match="bad batch"):
            poisoned.get(timeout=5)
        for i in range(3):
            assert mb.submit(f"req{i}").get(timeout=5) == f"REQ{i}"
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit("late").get(timeout=5)


def test_microbatcher_concurrent_clients():
    """Many client threads: every request gets its own answer back."""
    mb = MicroBatcher(lambda batch: [r * 2 for r in batch],
                      BatcherConfig(max_batch=8, max_wait_ms=1.0))
    out = {}
    lock = threading.Lock()

    def client(c):
        for i in range(c * 50, c * 50 + 50):
            v = mb.submit(i).get(timeout=10)
            with lock:
                out[i] = v

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        mb.close()
    assert out == {i: 2 * i for i in range(400)}


def test_default_device_needs_a_card(ref_warren):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None serves on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalServer(_carry(ref_warren), k=5)


# ------------------------------------------------------------------ #
# the native sharded path
# ------------------------------------------------------------------ #
SHARDED_QUERIES = ["school education student", "government law state",
                   "stock money business", "vibration conductor wind"]


def _sharded_pair(tmp_path=None, corpus_seed=7, n_docs=150, mean_len=40):
    """The same ShardedWarren (3 groups × 2 replicas, async scatter) built
    by each package: (reference, port)."""
    from repro.dist.shard_router import ShardedWarren as RefSharded
    from repro_torch.core import ingest_documents
    from repro_torch.dist.shard_router import ShardedWarren
    corpus = list(doc_generator(corpus_seed, n_docs, mean_len=mean_len))
    out = []
    for cls, ingest, sub in ((RefSharded, ref_ingest, "ref"),
                             (ShardedWarren, ingest_documents, "port")):
        kw = {} if tmp_path is None else {
            "static_dir": str(tmp_path / sub)}
        w = cls(n_shards=3, replicas=2, async_scatter=True, **kw)
        ingest(w, corpus, batch=16)
        out.append(w)
    return out


def _rows_both(ref_w, port_w, queries, **kw):
    ref = RefServer(ref_w, k=10, **kw)
    port = RetrievalServer(port_w, k=10, device="cpu", **kw)
    try:
        return _serve_all(ref, queries), _serve_all(port, queries)
    finally:
        ref.close()
        port.close()


@pytest.fixture(scope="module")
def sharded_pair():
    pair = _sharded_pair()
    yield pair
    for w in pair:
        w.close()


@pytest.mark.parametrize("max_postings", [4096, 8])
def test_sharded_server_matches_jax_sharded_server(sharded_pair,
                                                   max_postings):
    """The native path (one fan-out per group, global stats and posting
    cap, per-group top-k, the (-score, address) merge) on the CPU: the
    JAX sharded server's rows bit for bit, duplicates in a batch too."""
    queries = SHARDED_QUERIES + QUERIES + SHARDED_QUERIES[:2]
    ref, port = _rows_both(*sharded_pair, queries, max_postings=max_postings)
    assert port == ref
    assert sum(len(r) for r in port) > 0


def test_sharded_server_over_demoted_group(tmp_path):
    """A demoted group is read from its static runs: still the JAX
    server's rows, and the same as before the demotion."""
    ref_w, port_w = _sharded_pair(tmp_path, corpus_seed=11, n_docs=90,
                                  mean_len=30)
    before, _ = _rows_both(ref_w, port_w, SHARDED_QUERIES)
    for w in (ref_w, port_w):
        w.demote_group(1)
    assert port_w.demoted()[1] is not None
    ref, port = _rows_both(ref_w, port_w, SHARDED_QUERIES)
    assert port == ref == before
    for w in (ref_w, port_w):
        w.close()


def test_sharded_server_after_split():
    """After a split has interleaved the groups' address ranges: the JAX
    server's rows, and the port's own non-native path (one merged
    surface) gives the same addresses and scores."""
    from repro.dist.rebalance import Rebalancer as RefRebalancer
    from repro_torch.dist.rebalance import Rebalancer
    ref_w, port_w = _sharded_pair(n_docs=90)
    counts = port_w.group_doc_counts()
    largest = counts.index(max(counts))
    assert RefRebalancer(ref_w).split_group(largest) == \
        Rebalancer(port_w).split_group(largest)
    ref, port = _rows_both(ref_w, port_w, SHARDED_QUERIES)
    assert port == ref
    native = RetrievalServer(port_w, k=10, device="cpu")
    legacy = RetrievalServer(port_w.clone(), k=10, sharded_native=False,
                             device="cpu")
    try:
        got = native._handle(SHARDED_QUERIES)
        want = legacy._handle(SHARDED_QUERIES)
    finally:
        native.close()
        legacy.close()
    for g, w in zip(got, want):
        assert [(d, round(s, 9)) for d, s in g] == \
            [(d, round(s, 9)) for d, s in w]
    for w in (ref_w, port_w):
        w.close()


def _grouped(warren, rows):
    """(rounded score, texts) with equal-score ties as sets — a sharded
    and a single warren lay addresses out differently by design."""
    with warren:
        docs = warren.annotations(":")
        ends = {int(s): int(e) for s, e in zip(docs.starts, docs.ends)}
        pairs = [(round(s, 9), warren.translate(d, ends[d]))
                 for d, s in rows]
    out, i = [], 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][0] == pairs[i][0]:
            j += 1
        out.append((pairs[i][0], frozenset(t for _, t in pairs[i:j])))
        i = j
    return out


@pytest.mark.parametrize("max_postings", [4096, 8])
def test_sharded_server_matches_single_server(sharded_pair, max_postings):
    """Against the single index of the same documents (the reference
    serving test's corpus): the same ranking by (score, text), ties as
    sets."""
    from repro_torch.core import DynamicIndex, ingest_documents
    _, port_w = sharded_pair
    single = Warren(DynamicIndex())
    ingest_documents(single, doc_generator(7, 150, mean_len=40), batch=16)
    sharded = RetrievalServer(port_w, k=10, max_postings=max_postings,
                              device="cpu")
    flat = RetrievalServer(single, k=10, max_postings=max_postings,
                           device="cpu")
    try:
        got = _serve_all(sharded, SHARDED_QUERIES * 2)
        want = _serve_all(flat, SHARDED_QUERIES * 2)
    finally:
        sharded.close()
        flat.close()
    for g, w in zip(got, want):
        assert _grouped(port_w, g) == _grouped(single, w)


def test_sharded_server_sees_new_commits_and_keeps_no_stats(sharded_pair):
    """The native path scatters fresh stats every batch: a document
    committed after the server started is found at once; refresh_stats
    has nothing to do."""
    from repro_torch.core import index_document
    _, port_w = sharded_pair
    server = RetrievalServer(port_w, k=5, device="cpu")
    try:
        assert server.stats is None
        server.refresh_stats()
        writer = port_w.clone()
        with writer:
            writer.transaction()
            index_document(writer, "xylophone quartz unique",
                           docid="fresh-doc")
            writer.commit()
        res = server.query("xylophone quartz", timeout=30)
        assert len(res) == 1
        with writer:
            lst = writer.annotations("docid:fresh-doc")
            assert res[0][0] == int(lst.starts[0])
            writer.transaction()
            writer.erase(int(lst.starts[0]), int(lst.ends[0]))
            writer.commit()
        assert server.query("xylophone quartz", timeout=30) == []
        snap = server.timings.snapshot()
        assert snap["queries"] == 2 and snap["scatter_s"] > 0
    finally:
        server.close()


def test_sharded_server_empty_warren_and_spans():
    from repro_torch.dist.shard_router import ShardedWarren
    w = ShardedWarren(n_shards=3)
    server = RetrievalServer(w, k=5, device="cpu")
    tr = obs.tracer()
    tr.reset()
    try:
        assert server.query("school", timeout=30) == []
    finally:
        server.close()
    assert tr.traces()[-1].names()[0] == "serve.batch"


def test_scatter_timings_moved_to_parallel():
    import repro_torch.serve
    from repro_torch.dist.parallel import ScatterTimings
    assert repro_torch.serve.ScatterTimings is ScatterTimings
    t = ScatterTimings(site="test")
    t.add(scatter=0.001, score=0.002, merge=0.003, queries=2)
    assert t.window()["queries"] == 2 and t.snapshot()["queries"] == 0
