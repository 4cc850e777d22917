"""The port's host index against the reference package's, on the same docs.

Same documents through both ``ingest_documents`` must give the same
annotation lists (addresses, feature ids, float64 values), the same
collection statistics and the same float64 BM25 scores; segment records
carried across with ``index_from_records`` must serve the same lists.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as jcore
from repro.data.synth import doc_generator as jdoc_generator
from repro_torch import core as tcore
from repro_torch.convert import index_from_records
from repro_torch.data.synth import _WORDS, doc_generator

N_DOCS = 240
QUERIES = ["school education student", "government law state",
           "stock money business", "vibration conductor wind",
           "time year people way day man thing woman", "unseenword"]


def _lists_equal(a, b):
    return (np.array_equal(a.starts, b.starts)
            and np.array_equal(a.ends, b.ends)
            and np.array_equal(a.values, b.values))


@pytest.fixture(scope="module")
def pair():
    ref = jcore.Warren(jcore.DynamicIndex())
    jcore.ingest_documents(ref, jdoc_generator(5, N_DOCS, mean_len=40),
                           batch=32)
    port = tcore.Warren(tcore.DynamicIndex())
    tcore.ingest_documents(port, doc_generator(5, N_DOCS, mean_len=40),
                           batch=32)
    return ref, port


@pytest.fixture(scope="module")
def carried(pair):
    ref, _ = pair
    records = [s.to_record() for s in ref.index._segments]
    return tcore.Warren(index_from_records(records))


def _features():
    stems = sorted({tcore.porter_stem(w) for w in _WORDS})
    return [":", "dl:", "docid:doc5_7"] + ["tf:porter:" + s for s in stems]


def test_corpus_is_the_same():
    assert list(doc_generator(9, 20)) == list(jdoc_generator(9, 20))


@pytest.mark.parametrize("which", ["ingested", "carried"])
def test_annotation_lists_identical(pair, carried, which):
    ref, port = pair
    other = port if which == "ingested" else carried
    with ref, other:
        for f in _features():
            assert ref.featurize(f) == other.featurize(f), f
            assert _lists_equal(ref.annotations(f), other.annotations(f)), f
        # word-occurrence lists, added by append
        for w in _WORDS[:20]:
            assert _lists_equal(ref.annotations(w), other.annotations(w)), w


@pytest.mark.parametrize("which", ["ingested", "carried"])
def test_collection_stats_identical(pair, carried, which):
    ref, port = pair
    other = port if which == "ingested" else carried
    with ref, other:
        a, b = jcore.collection_stats(ref), tcore.collection_stats(other)
    assert a.n_docs == b.n_docs == N_DOCS
    assert a.avgdl == b.avgdl
    for f in ("doc_starts", "doc_ends", "doc_lens"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("query", QUERIES)
def test_score_bm25_exact(pair, carried, query):
    ref, port = pair
    with ref, port, carried:
        want = jcore.score_bm25(ref, query, k=15)
        assert tcore.score_bm25(port, query, k=15) == want
        assert tcore.score_bm25(carried, query, k=15) == want


def test_translate_and_text_identical(pair, carried):
    ref, port = pair
    with ref, port, carried:
        docs = ref.annotations(":")
        for p, q in list(zip(docs.starts, docs.ends))[::37]:
            want = ref.translate(int(p), int(q))
            assert want is not None
            assert port.translate(int(p), int(q)) == want
            assert carried.translate(int(p), int(q)) == want


def test_carried_index_takes_new_commits(carried):
    """New transactions on a carried-over index land after its segments."""
    w = carried.clone()
    with w:
        before = w.annotations(":")
        w.transaction()
        lo, _ = tcore.index_document(w, "xylophone quartz", docid="new")
        remap = w.commit()
    with w:
        after = w.annotations(":")
    assert remap(lo) == int(after.starts[-1]) > int(before.ends[-1])
    assert len(after) == len(before) + 1


def test_block_impacts_identical(pair):
    ref, port = pair
    terms = QUERIES[0].split()
    with ref, port:
        a = jcore.build_block_impacts(ref, terms, block_size=16)
        b = tcore.build_block_impacts(port, terms, block_size=16)
        assert jcore.score_blockmax(a, k=10) == tcore.score_blockmax(b, k=10)
    assert a.n_blocks == b.n_blocks and a.terms == b.terms
    for x, y in zip(a.term_blocks, b.term_blocks):
        for key in ("blocks", "offsets", "di", "imp", "bmax"):
            assert np.array_equal(x[key], y[key]), key


def test_erase_and_merge_match(pair):
    """Erase + segment merge: the same visible lists in both packages."""
    ref = jcore.Warren(jcore.DynamicIndex())
    port = tcore.Warren(tcore.DynamicIndex())
    for w, core in ((ref, jcore), (port, tcore)):
        core.ingest_documents(w, doc_generator(6, 40), batch=8)
        with w:
            docs = w.annotations(":")
            w.transaction()
            w.erase(int(docs.starts[3]), int(docs.ends[5]))
            w.commit()
        w.index.merge_segments()
    with ref, port:
        for f in _features()[:12]:
            assert _lists_equal(ref.annotations(f), port.annotations(f)), f


def test_durable_log_concurrent_commits_recover(tmp_path):
    """Writers on several threads commit to a file-backed log; both
    packages recover the same index from it."""
    import threading

    path = str(tmp_path / "wal.log")
    live = tcore.Warren(tcore.DynamicIndex(log_path=path))
    docs = list(doc_generator(8, 48, mean_len=20))

    def writer(part):
        w = live.clone()
        for docid, text in docs[part::4]:
            with w:
                w.transaction()
                tcore.index_document(w, text, docid=docid)
                w.commit()

    threads = [threading.Thread(target=writer, args=(p,)) for p in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    port = tcore.Warren(tcore.DynamicIndex.recover(path))
    ref = jcore.Warren(jcore.DynamicIndex.recover(path))
    with live, port, ref:
        assert len(live.annotations(":")) == len(docs)
        for f in _features()[:12]:
            want = live.annotations(f)
            assert _lists_equal(port.annotations(f), want), f
            assert _lists_equal(ref.annotations(f), want), f
