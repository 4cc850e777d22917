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


def test_sharded_warren_is_refused():
    class Grouped:
        def map_groups(self, fn):
            raise AssertionError("must not be called")

    with pytest.raises(NotImplementedError, match="sharded"):
        RetrievalServer(Grouped(), device="cpu")
