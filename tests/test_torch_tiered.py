"""The port's tiered store against the reference's and a single index.

The same op stream (appends, annotates, erases, aborts, freezes and run
compactions) goes into the port's ``TieredWarren``, the reference's, and
a single-index ``Warren``: every list, ``translate`` and BM25 top-k must
be equal bit for bit, since all three allocate addresses the same way.
The crash matrix replays each freeze / compaction / cold split once per
fsync or rename boundary (the port's own fault hook) and checks
latest-good recovery.  Each package opens the other's run files, and
writes the same bytes; the port's server over a TieredWarren answers as
over a Warren of the same documents.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro.core import DynamicIndex as RefIndex
from repro.core import Warren as RefWarren
from repro.core import index_document as ref_index_document
from repro.core.static import StaticIndex as RefStaticIndex
from repro.core.static import write_run as ref_write_run
from repro.tiered import TieredStore as RefTieredStore
from repro.tiered import demote_index as ref_demote_index
from repro.tiered import resurrect_index as ref_resurrect_index
from repro.train.serve import RetrievalServer as RefServer
from repro_torch.core import (DynamicIndex, StaticIndex, Warren,
                              index_document, score_bm25, write_run,
                              write_static)
from repro_torch.core.faults import InjectedCrash, set_hook
from repro_torch.core.runfile import RUN_FILE
from repro_torch.serve import RetrievalServer
from repro_torch.tiered import (LeveledPolicy, StaticWarren, TieredStore,
                                demote_index, resurrect_index, split_demoted)

VOCAB = ["school", "education", "student", "government", "law", "state",
         "stock", "money", "business", "vibration", "conductor", "wind"]
FEATURES = (":", "docid:d5", "docid:d21", "docid:d3", "docid:d17")
QUERIES = ("school education student", "government law state")


@pytest.fixture(autouse=True)
def _always_clear_hook():
    yield
    set_hook(None)


def _text(n: int) -> str:
    return " ".join(VOCAB[(n * 7 + i * (1 + n % 5)) % len(VOCAB)]
                    for i in range(3 + n % 6))


def _ingest(warren, ids, index_doc=index_document):
    with warren:
        warren.transaction()
        for n in ids:
            index_doc(warren, _text(n), docid=f"d{n}")
        warren.commit()


def _erase(warren, docid):
    with warren:
        lst = warren.annotations("docid:" + docid)
        warren.transaction()
        warren.erase(int(lst.starts[0]), int(lst.ends[0]))
        warren.commit()


def _same_lists(a, b, features):
    with a, b:
        for f in features:
            x, y = a.annotations(f), b.annotations(f)
            assert np.array_equal(x.starts, y.starts), f
            assert np.array_equal(x.ends, y.ends), f
            assert np.array_equal(x.values, y.values), f


# ------------------------------------------------------------------ #
# equivalence: port tiered == reference tiered == single index
# ------------------------------------------------------------------ #
def _apply_ops(warren, ops, index_doc, store=None):
    """The reference tiered test's interpreter: freeze / compact flush the
    staged batch on every side and act only on a store."""
    docs, staged = [], []

    def flush(commit: bool):
        nonlocal staged
        batch, staged = staged, []
        if not batch:
            return
        with warren:
            warren.transaction()
            spans = []
            for kind, a, b, c in batch:
                if kind == "append":
                    spans.append(index_doc(warren, _text(a), docid=f"d{a}"))
                elif kind == "annotate" and docs:
                    lo, hi = docs[a % len(docs)]
                    warren.annotate(f"tag{b % 4}:", lo, hi, float(c))
                elif kind == "erase" and docs:
                    lo, hi = docs[a % len(docs)]
                    warren.erase(lo, hi)
            if commit:
                remap = warren.commit()
                docs.extend((remap(lo), remap(hi)) for lo, hi in spans)
            else:
                warren.abort()

    for op in ops:
        if op[0] in ("commit", "abort"):
            flush(op[0] == "commit")
        elif op[0] in ("freeze", "compact"):
            flush(True)
            if store is not None:
                (store.freeze if op[0] == "freeze"
                 else store.compact_runs)()
        else:
            staged.append(op)
    flush(True)
    return docs


OPS = st.lists(
    st.tuples(st.sampled_from(["append", "append", "append", "annotate",
                               "erase", "commit", "abort", "freeze",
                               "compact"]),
              st.integers(0, 30), st.integers(0, 10), st.integers(0, 100)),
    min_size=4, max_size=36)


@settings(database=None, derandomize=True, deadline=None, max_examples=10)
@given(OPS)
def test_tiered_equivalence_property(tmp_path_factory, ops):
    d = tmp_path_factory.mktemp("tiered")
    port_store = TieredStore(str(d / "port"), auto_merge_threshold=3)
    ref_store = RefTieredStore(str(d / "ref"), auto_merge_threshold=3)
    single = Warren(DynamicIndex())
    tw, rw = port_store.warren(), ref_store.warren()
    docs = _apply_ops(tw, ops, index_document, store=port_store)
    assert _apply_ops(rw, ops, ref_index_document, store=ref_store) == docs
    assert _apply_ops(single, ops, index_document) == docs
    assert port_store.n_runs == ref_store.n_runs
    features = ([":", "dl:"] + [f"tag{i}:" for i in range(4)]
                + [f"docid:d{i}" for i in range(31)] + VOCAB)
    _same_lists(tw, rw, features)
    _same_lists(tw, single, features)
    with tw, single:
        for lo, hi in docs:
            assert tw.translate(lo, hi) == single.translate(lo, hi)
            assert tw.tokens(lo, hi) == single.tokens(lo, hi)
        q = " ".join(VOCAB[:4])
        assert score_bm25(tw, q, k=10) == score_bm25(single, q, k=10)
    port_store.close()
    ref_store.close()


# ------------------------------------------------------------------ #
# the crash matrix (the port's own fault hook)
# ------------------------------------------------------------------ #
def _oracle(n=30, erased=("d3", "d17")):
    w = Warren(DynamicIndex())
    _ingest(w, range(n))
    for d in erased:
        _erase(w, d)
    return w


def _view(warren, feature):
    lst = warren.annotations(feature)
    return sorted(((warren.translate(int(s), int(e)), float(v))
                   for s, e, v in zip(lst.starts, lst.ends, lst.values)),
                  key=lambda t: (t[0] or "", t[1]))


def _assert_oracle_parity(warren, oracle):
    with warren, oracle:
        for f in FEATURES:
            assert _view(warren, f) == _view(oracle, f), f
        for q in QUERIES:
            assert [s for _, s in score_bm25(warren, q, k=10)] == \
                [s for _, s in score_bm25(oracle, q, k=10)]


def _crash_at(k):
    state = {"n": 0}

    def hook(name):
        n = state["n"]
        state["n"] += 1
        if n == k:
            raise InjectedCrash(name, n)
    return hook


def _count_boundaries(op):
    names = []
    set_hook(names.append)
    try:
        op()
    finally:
        set_hook(None)
    return names


def _assert_no_orphans(store_dir, manifest):
    runs_dir = os.path.join(store_dir, "runs")
    if os.path.isdir(runs_dir):
        assert set(os.listdir(runs_dir)) == {i.name for i in manifest.runs}


def _seed(path, n=30, erased=("d3", "d17"), batches=0):
    """A store whose documents are hot (``batches=0``) or in runs."""
    store = TieredStore(path)
    w = store.warren()
    if batches:
        per = n // batches
        for b in range(batches):
            _ingest(w, range(b * per, (b + 1) * per))
            store.freeze()
    else:
        _ingest(w, range(n))
    for d in erased:
        _erase(w, d)
    if batches:
        store.freeze()
    store.close()


def _reference_boundaries(tmp_path, seed_dir, op):
    """The fault points the reference store crosses on the same op."""
    from repro.core.faults import set_hook as ref_set_hook
    probe = str(tmp_path / "ref_probe")
    shutil.copytree(seed_dir, probe)
    st = RefTieredStore(probe)
    names = []
    ref_set_hook(names.append)
    try:
        op(st)
    finally:
        ref_set_hook(None)
    st.close()
    return names


def test_freeze_crash_matrix(tmp_path):
    seed = str(tmp_path / "seed")
    _seed(seed)
    oracle = _oracle()
    probe = str(tmp_path / "probe")
    shutil.copytree(seed, probe)
    st = TieredStore(probe)
    names = _count_boundaries(st.freeze)
    st.close()
    assert names == _reference_boundaries(tmp_path, seed,
                                          lambda s: s.freeze())
    for expected in ("run.blocks_written", "run.synced",
                     "static.pre_publish", "static.published",
                     "manifest.written", "manifest.published"):
        assert expected in names, names
    for k in range(len(names)):
        work = str(tmp_path / f"f{k}")
        shutil.copytree(seed, work)
        store = TieredStore(work)
        set_hook(_crash_at(k))
        with pytest.raises(InjectedCrash):
            store.freeze()
        set_hook(None)
        recovered = TieredStore(work)
        _assert_oracle_parity(recovered.warren(), oracle)
        _assert_no_orphans(work, recovered.manifest)
        recovered.freeze()
        _assert_oracle_parity(recovered.warren(), oracle)
        recovered.close()


def test_compact_level_crash_matrix(tmp_path):
    seed = str(tmp_path / "seed")
    _seed(seed, batches=3)
    oracle = _oracle()
    policy = LeveledPolicy(l0_trigger=2)
    probe = str(tmp_path / "probe")
    shutil.copytree(seed, probe)
    st = TieredStore(probe)
    assert st.n_runs >= 2
    names = _count_boundaries(lambda: st.compact_level(policy))
    st.close()
    from repro.tiered import LeveledPolicy as RefPolicy
    assert names == _reference_boundaries(
        tmp_path, seed, lambda s: s.compact_level(RefPolicy(l0_trigger=2)))
    for k in range(len(names)):
        work = str(tmp_path / f"c{k}")
        shutil.copytree(seed, work)
        store = TieredStore(work)
        set_hook(_crash_at(k))
        with pytest.raises(InjectedCrash):
            store.compact_level(policy)
        set_hook(None)
        recovered = TieredStore(work)
        _assert_oracle_parity(recovered.warren(), oracle)
        _assert_no_orphans(work, recovered.manifest)
        committed = any(i.level >= 1 for i in recovered.manifest.runs)
        info = recovered.compact_level(policy)
        assert (info is None) if committed else (info.level == 1)
        _assert_oracle_parity(recovered.warren(), oracle)
        recovered.close()


def test_split_demoted_crash_matrix(tmp_path):
    seed = str(tmp_path / "seed")
    _seed(seed, batches=3)
    oracle = _oracle()
    with StaticWarren(seed) as sw:
        docs = sw.annotations(":")
        pivot = int(sorted(int(s) for s in docs.starts)[len(docs) // 2])
    probe = str(tmp_path / "probe")
    shutil.copytree(seed, probe)
    names = _count_boundaries(lambda: split_demoted(
        probe, str(tmp_path / "pk"), str(tmp_path / "pm"), pivot))
    assert "split.shipped" in names
    with oracle:
        want = {f: _view(oracle, f) for f in FEATURES}
    for k in range(len(names)):
        keep, moved = str(tmp_path / f"k{k}"), str(tmp_path / f"m{k}")
        set_hook(_crash_at(k))
        with pytest.raises(InjectedCrash):
            split_demoted(seed, keep, moved, pivot)
        set_hook(None)
        with StaticWarren(seed) as sw:
            for f in FEATURES:
                assert _view(sw, f) == want[f], f
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(moved, ignore_errors=True)
        split_demoted(seed, keep, moved, pivot)
        with StaticWarren(keep) as a, StaticWarren(moved) as b:
            for f in FEATURES:
                assert sorted(_view(a, f) + _view(b, f)) == want[f], f


def test_write_static_overwrite_crash_keeps_a_good_layout(tmp_path):
    w_old, w_new = Warren(DynamicIndex()), Warren(DynamicIndex())
    _ingest(w_old, range(5))
    _ingest(w_new, range(9))
    d = str(tmp_path / "layout")
    write_static(w_old.index, d)
    names = _count_boundaries(
        lambda: write_static(w_new.index, str(tmp_path / "probe")))
    for k in range(len(names)):
        work = str(tmp_path / f"w{k}")
        shutil.copytree(d, work)
        set_hook(_crash_at(k))
        with pytest.raises(InjectedCrash):
            write_static(w_new.index, work)
        set_hook(None)
        si = StaticIndex(work)
        assert len(si.annotations(":")) in (5, 9)
        si.close()


def test_crash_after_manifest_before_wal_compaction(tmp_path):
    """Manifest published, the WAL still holding the frozen segments:
    reopening must not count them twice."""
    d = str(tmp_path / "t")
    store = TieredStore(d)
    _ingest(store.warren(), range(9))
    orig = store.hot.compact_log

    def crash():
        if store.manifest.frozen_upto >= 0:
            raise RuntimeError("simulated crash before WAL compaction")
        orig()
    store.hot.compact_log = crash
    with pytest.raises(RuntimeError):
        store.freeze()
    store.hot._log.close()
    store2 = TieredStore(d)
    assert store2.n_runs == 1
    w = store2.warren()
    with w:
        assert len(w.annotations(":")) == 9
    store2.close()


def test_freeze_never_strands_a_pending_lower_seq_txn(tmp_path):
    d = str(tmp_path / "t")
    store = TieredStore(d)
    w = store.warren()
    _ingest(w, range(4))
    pending = store.hot.transaction()
    pending.append("pendingalpha limbo tokens")
    pending.ready()
    _ingest(w, [99])
    store.freeze()
    assert store.manifest.frozen_upto < pending._segment.seqnum
    pending.commit()
    store.close()
    store2 = TieredStore(d)
    w2 = store2.warren()
    with w2:
        assert len(w2.annotations("pendingalpha")) == 1
        assert len(w2.annotations(":")) == 5
    store2.close()


# ------------------------------------------------------------------ #
# runs and demoted groups: each package reads the other's files
# ------------------------------------------------------------------ #
def _pair_indexes(n=40):
    ref, port = RefWarren(RefIndex()), Warren(DynamicIndex())
    for w, index_doc in ((ref, ref_index_document), (port, index_document)):
        _ingest(w, range(n // 2), index_doc)
        _ingest(w, range(n // 2, n), index_doc)
        _erase(w, "d7")
    return ref, port


RUN_FEATURES = (":", "docid:d1", "docid:d7", "school", "wind", "dl:")


def test_runs_cross_read_and_byte_equal(tmp_path):
    ref, port = _pair_indexes()
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_meta = ref_write_run(ref.index._segments, ref_dir)
    port_meta = write_run(port.index._segments, port_dir)
    assert ref_meta == port_meta
    with open(os.path.join(ref_dir, RUN_FILE), "rb") as a, \
            open(os.path.join(port_dir, RUN_FILE), "rb") as b:
        assert a.read() == b.read()
    for mine, theirs in ((StaticIndex(ref_dir), RefStaticIndex(port_dir)),
                         (StaticIndex(port_dir), RefStaticIndex(ref_dir))):
        for f in RUN_FEATURES:
            fv = port.index.featurizer.featurize(f)
            a, b = mine.annotations(fv), theirs.annotations(fv)
            assert np.array_equal(a.starts, b.starts), f
            assert np.array_equal(a.ends, b.ends), f
            assert np.array_equal(a.values, b.values), f
        mine.close()
        theirs.close()


def test_demote_and_resurrect_across_packages(tmp_path):
    """A run set demoted by one package is resurrected by the other into
    the same segments, floors and lists."""
    ref, port = _pair_indexes()
    ref_demote_index(ref.index, str(tmp_path / "ref"))
    demote_index(port.index, str(tmp_path / "port"))
    a = resurrect_index(str(tmp_path / "ref"), n=2)
    b = ref_resurrect_index(str(tmp_path / "port"), n=2)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert (x._next_addr, x._next_seq) == (y._next_addr, y._next_seq)
        assert [s.to_record() for s in x._segments] == \
            [s.to_record() for s in y._segments]
    sw = StaticWarren(str(tmp_path / "ref"))
    _same_lists(sw, port, RUN_FEATURES)
    sw.close()


# ------------------------------------------------------------------ #
# serving over runs plus a hot memtable
# ------------------------------------------------------------------ #
SERVE_QUERIES = ["school education student", "government law state",
                 "stock money business", "vibration conductor wind",
                 "wind", "nothingmatches"]


@pytest.mark.parametrize("max_postings", [4096, 8])
def test_server_over_tiered_warren_is_the_warren_s(tmp_path, max_postings):
    """Four runs plus a hot segment: the port's server gives a Warren's
    rows bit for bit (addresses, score bits, order), before and after a
    compaction, and the JAX server's over the reference's TieredWarren."""
    store = TieredStore(str(tmp_path / "port"))
    ref_store = RefTieredStore(str(tmp_path / "ref"))
    flat = Warren(DynamicIndex())
    tw, rw = store.warren(), ref_store.warren()
    for b in range(5):
        ids = range(b * 12, (b + 1) * 12)
        for w, index_doc in ((tw, index_document), (flat, index_document),
                             (rw, ref_index_document)):
            _ingest(w, ids, index_doc)
        if b < 4:
            store.freeze()
            ref_store.freeze()
    assert store.n_runs == 4 and store.hot._segments

    def rows(server):
        try:
            handles = [server.batcher.submit(q) for q in SERVE_QUERIES]
            return [h.get(timeout=60) for h in handles]
        finally:
            server.close()

    want = rows(RetrievalServer(flat, k=10, max_postings=max_postings,
                                device="cpu"))
    assert any(want)
    assert rows(RetrievalServer(tw, k=10, max_postings=max_postings,
                                device="cpu")) == want
    assert rows(RefServer(rw, k=10, max_postings=max_postings)) == want
    store.compact_runs()
    assert store.n_runs == 1
    assert rows(RetrievalServer(tw, k=10, max_postings=max_postings,
                                device="cpu")) == want
    store.close()
    ref_store.close()
