"""The paper's other retrieval modes in the port against the reference:
learned sparse and hybrid scoring (``core/sparse.py``), WAND, RM3-style
expansion and average precision (``core/ranking.py``) and graphs as
annotations (``core/graph_store.py``).  The same documents, sparse
vectors and edges go into each package's warren; every result (addresses,
score bits, order, expansion weights, edge lists) must be equal.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
import repro.core.sparse as RSP  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.core.sparse as TSP  # noqa: E402
from repro.data.synth import doc_generator as ref_docs  # noqa: E402
from repro_torch.data.synth import doc_generator  # noqa: E402

PKGS = ((RC, RSP, ref_docs), (TC, TSP, doc_generator))
QUERIES = ["school education student", "government law state",
           "stock money business", "vibration conductor wind",
           "the of and", "zzzz unseen", ""]
N_DOCS = 300


def _vectors(n: int, vocab: int = 40, seed: int = 3):
    """Seeded sparse vectors: a few tokens of a small vocabulary each,
    weights with ties and zeros (a zero weight is not indexed)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.choice(vocab, size=int(rng.integers(1, 6)), replace=False)
        w = np.round(rng.uniform(0.0, 3.0, len(toks)), 1)
        out.append({f"t{t}": float(x) for t, x in zip(toks, w)})
    return out


def _build(pkg):
    core, sparse, docs = pkg
    w = core.Warren(core.DynamicIndex())
    core.ingest_documents(w, docs(5, N_DOCS, mean_len=40), batch=64)
    with w:
        ext = w.annotations(":")
        extents = list(zip(ext.starts.tolist(), ext.ends.tolist()))
        w.transaction()
        n = sum(sparse.index_sparse_vector(w, e, v, method="splade")
                for e, v in zip(extents, _vectors(len(extents))))
        w.commit()
    return w, extents, n


@pytest.fixture(scope="module")
def warrens():
    return [_build(pkg) for pkg in PKGS]


def _same(a, b):
    """Rows equal in addresses, order and score bits."""
    assert [d for d, _ in a] == [d for d, _ in b]
    assert np.array_equal(np.array([s for _, s in a], dtype=np.float64),
                          np.array([s for _, s in b], dtype=np.float64))
    assert all(type(d) is int for d, _ in b)


def test_the_same_warren(warrens):
    (rw, rext, rn), (tw, text, tn) = warrens
    assert rext == text and rn == tn > 0


@pytest.mark.parametrize("query,k", [
    ({"t1": 1.0}, 10), ({"t1": 1.0, "t2": 0.5, "t3": 2.0}, 25),
    ({"t7": 0.3, "t8": 0.3}, 1), ({"t39": 1.0}, 1000), ({"nope": 1.0}, 5),
    ({"t5": -1.0, "t6": 2.0}, 10)])
def test_score_sparse_equal(warrens, query, k):
    (rw, _, _), (tw, _, _) = warrens
    with rw, tw:
        _same(RSP.score_sparse(rw, query, k=k),
              TSP.score_sparse(tw, query, k=k))
        # passages as the scored units: every other document extent
        rext, text = rw.annotations(":"), tw.annotations(":")
        sub = [type(e)(e.starts[::2], e.ends[::2], e.values[::2])
               for e in (rext, text)]
        _same(RSP.score_sparse(rw, query, k=k, extents=sub[0]),
              TSP.score_sparse(tw, query, k=k, extents=sub[1]))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("query", QUERIES[:4])
def test_score_hybrid_equal(warrens, query, alpha):
    (rw, _, _), (tw, _, _) = warrens
    qw = {"t1": 1.0, "t4": 0.5, "t9": 1.5}
    with rw, tw:
        _same(RSP.score_hybrid(rw, query, qw, k=10, alpha=alpha),
              TSP.score_hybrid(tw, query, qw, k=10, alpha=alpha))


@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("query", QUERIES)
def test_score_wand_equal_and_exact(warrens, query, k):
    (rw, _, _), (tw, _, _) = warrens
    with rw, tw:
        got = TC.score_wand(tw, query, k=k)
        _same(RC.score_wand(rw, query, k=k), got)
        # WAND keeps the exhaustive scorer's top scores; it adds a
        # document's impacts in its cursors' order, so a score may differ
        # from score_bm25's sum in the last bit (the reference's too)
        want = dict(TC.score_bm25(tw, query, k=N_DOCS))
        for d, s in got:
            assert s == pytest.approx(want[d], rel=1e-12, abs=0)
        top = sorted(want.values(), reverse=True)[:len(got)]
        assert [s for _, s in got] == pytest.approx(top, rel=1e-12, abs=0)


@pytest.mark.parametrize("fb_docs,fb_terms,orig", [(20, 20, 0.6),
                                                    (5, 8, 0.3),
                                                    (1, 1, 1.0)])
@pytest.mark.parametrize("query", QUERIES[:5])
def test_expand_query_equal(warrens, query, fb_docs, fb_terms, orig):
    (rw, _, _), (tw, _, _) = warrens
    with rw, tw:
        a = RC.expand_query(rw, query, fb_docs=fb_docs, fb_terms=fb_terms,
                            orig_weight=orig)
        b = TC.expand_query(tw, query, fb_docs=fb_docs, fb_terms=fb_terms,
                            orig_weight=orig)
    assert list(a.items()) == list(b.items())
    from repro_torch.core.ranking import _STOP, ranking_tokens
    fed = set(b) - set(ranking_tokens(query))
    assert not fed & _STOP


@pytest.mark.parametrize("ranked,relevant", [
    ([3, 1, 4, 1, 5, 9, 2, 6], {1, 9, 7}), ([], {1}), ([1, 2, 3], set()),
    (list(range(100)), set(range(0, 100, 7))), ([5], {5})])
def test_average_precision_equal(ranked, relevant):
    a = RC.average_precision(ranked, relevant)
    b = TC.average_precision(ranked, relevant)
    assert a == b and type(a) is type(b)


def test_average_precision_of_served_rankings(warrens):
    (rw, _, _), (tw, _, _) = warrens
    with rw, tw:
        for q in QUERIES[:4]:
            r = [d for d, _ in RC.score_wand(rw, q, k=50)]
            t = [d for d, _ in TC.score_wand(tw, q, k=50)]
            rel = set(r[::3])
            assert RC.average_precision(r, rel) == \
                TC.average_precision(t, rel)


# --------------------------------------------------------------------- #
# the reference's own cases (tests/test_sparse_and_edges.py), each package
# --------------------------------------------------------------------- #
def _coexist(core, sparse):
    w = core.Warren(core.DynamicIndex())
    docs = ["the quick brown fox", "lazy dogs sleep all day",
            "foxes hunt at night", "markets rallied on tech news"]
    extents = []
    with w:
        w.transaction()
        for i, d in enumerate(docs):
            extents.append(core.index_document(w, d, docid=str(i)))
        remap = w.commit()
    extents = [(remap(a), remap(b)) for a, b in extents]
    vecs = [{"fox": 2.1, "animal": 1.3},
            {"dog": 1.8, "animal": 1.2, "rest": 0.7},
            {"fox": 1.9, "hunt": 1.5, "animal": 0.9},
            {"finance": 2.2, "market": 1.7}]
    with w:
        w.transaction()
        for ext, vec in zip(extents, vecs):
            sparse.index_sparse_vector(w, ext, vec, method="splade")
        w.commit()
    with w:
        top = sparse.score_sparse(w, {"animal": 1.0}, k=4)
        assert {d for d, _ in top} == {e[0] for e in extents[:3]}
        return (top, core.score_bm25(w, "fox", k=2),
                sparse.score_hybrid(w, "fox", {"fox": 1.0, "animal": 0.5},
                                    k=3), extents)


def test_sparse_vectors_coexist_with_bm25_equal():
    ref, port = _coexist(RC, RSP), _coexist(TC, TSP)
    for a, b in zip(ref[:3], port[:3]):
        _same(a, b)
    assert port[2][0][0] in (port[3][0][0], port[3][2][0])


def _edges(core):
    w = core.Warren(core.DynamicIndex())
    g = core.GraphStore(w)
    with w:
        w.transaction()
        a = g.add_node({"name": "a"})
        b = g.add_node({"name": "b"})
        c = g.add_node({"name": "c"})
        remap = w.commit()
    a, b, c = [(remap(x[0]), remap(x[1])) for x in (a, b, c)]
    with w:
        w.transaction()
        g.add_out_edges("@follows", a, [b[0], c[0], c[0]])
        w.commit()
    with w:
        before = g.out_edges("@follows", a)
        none = g.out_edges("@follows", b)
    with w:
        w.transaction()
        w.erase(*c)
        w.commit()
    with w:
        after = g.out_edges("@follows", a)
    assert sorted(before) == sorted([b[0], c[0]]) and after == [b[0]]
    with pytest.raises(ValueError):
        g.add_out_edges("@follows", (-1, 3), [1])
    return before, none, after


def test_edge_list_encoding_no_dangling_refs_equal():
    assert _edges(RC) == _edges(TC)


def _graph(core, n: int = 40, seed: int = 9):
    """A seeded graph of JSON nodes: direct edges anchored in their
    sources, triples, and a BFS from node 0."""
    rng = np.random.default_rng(seed)
    w = core.Warren(core.DynamicIndex())
    g = core.GraphStore(w)
    with w:
        w.transaction()
        nodes = [g.add_node({"id": i, "tags": [f"x{i % 3}", "y"]})
                 for i in range(n)]
        remap = w.commit()
    nodes = [(remap(a), remap(b)) for a, b in nodes]
    edges = [(int(s), int(t)) for s, t in rng.integers(0, n, (3 * n, 2))
             if s != t]
    with w:
        w.transaction()
        for s, t in edges:
            g.add_edge("@link", nodes[s][0], nodes[t][0])
        for s, t in edges[::4]:
            g.add_triple(nodes[s][0], "knows", nodes[t][0])
        w.commit()
    with w:
        out = {
            "neighbors": [g.neighbors("@link", *nd) for nd in nodes],
            "objects": [g.objects_of(nd, "knows") for nd in nodes],
            "containing": [g.containing_object(p) for p in
                           (nodes[0][0], nodes[5][1], nodes[-1][1] + 5)],
            "bfs": list(g.bfs("@link", nodes[0], max_nodes=n)),
            "bfs_cut": list(g.bfs("@link", nodes[1], max_nodes=5)),
            "values": [core.value_of(w, *nd) for nd in nodes[:5]]}
    return out


def test_graph_store_equal():
    ref, port = _graph(RC), _graph(TC)
    assert ref == port
    assert any(port["neighbors"]) and len(port["bfs"]) > 1
