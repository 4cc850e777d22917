"""The port's lazy GCL engine and query language against the reference's.

Each operator over the same lists must give the reference's solutions
(values included) and the brute-force oracle's, and answer every access
method the same; the query language over warrens built by both packages
from the same JSON collection must give the same solutions.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro import core as jcore
from repro.core import gcl as jgcl
from repro.core import query as jquery
from repro.core.annotation import reduce_minimal as jreduce
from repro.data.synth import json_collection as jjson_collection
from repro_torch import core as tcore
from repro_torch.core import gcl as tgcl
from repro_torch.core import query as tquery
from repro_torch.core.annotation import INF, NINF
from repro_torch.core.annotation import reduce_minimal as treduce
from repro_torch.data.synth import json_collection


def contains(outer, inner):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def g_reduce(intervals):
    ivs = sorted(set(intervals))
    return [a for a in ivs if not any(b != a and contains(a, b) for b in ivs)]


BRUTE = {
    "ContainedIn": lambda A, B: [a for a in A
                                 if any(contains(b, a) for b in B)],
    "Containing": lambda A, B: [a for a in A
                                if any(contains(a, b) for b in B)],
    "NotContainedIn": lambda A, B: [a for a in A
                                    if not any(contains(b, a) for b in B)],
    "NotContaining": lambda A, B: [a for a in A
                                   if not any(contains(a, b) for b in B)],
    "BothOf": lambda A, B: g_reduce([(min(a[0], b[0]), max(a[1], b[1]))
                                     for a in A for b in B]),
    "OneOf": lambda A, B: g_reduce(list(A) + list(B)),
    "FollowedBy": lambda A, B: g_reduce([(a[0], b[1]) for a in A for b in B
                                         if a[1] < b[0]]),
}

gc_list_strategy = st.lists(
    st.tuples(st.integers(0, 40), st.integers(0, 12), st.integers(0, 3))
    .map(lambda t: (t[0], t[0] + t[1], float(t[2]))),
    max_size=14,
)


def _lists(ivs):
    """The same G-reduced list in each package."""
    s = np.array([i[0] for i in ivs], dtype=np.int64)
    e = np.array([i[1] for i in ivs], dtype=np.int64)
    v = np.array([i[2] for i in ivs], dtype=np.float64)
    return jreduce(s, e, v), treduce(s, e, v)


@pytest.mark.parametrize("name", list(BRUTE))
@settings(max_examples=60, deadline=None)
@given(a=gc_list_strategy, b=gc_list_strategy)
def test_operator_matches_reference_and_brute_force(name, a, b):
    (ja, ta), (jb, tb) = _lists(a), _lists(b)
    want = getattr(jgcl, name)(jgcl.Term(ja), jgcl.Term(jb)).solutions()
    got = getattr(tgcl, name)(tgcl.Term(ta), tgcl.Term(tb)).solutions()
    assert got == want
    a_min = [(int(p), int(q)) for p, q, _ in ta]
    b_min = [(int(p), int(q)) for p, q, _ in tb]
    assert [(p, q) for p, q, _ in got] == sorted(set(BRUTE[name](a_min,
                                                                 b_min)))
    for k in range(-2, 56, 3):
        for method in ("tau", "rho", "tau_b", "rho_b"):
            jn = getattr(jgcl, name)(jgcl.Term(ja), jgcl.Term(jb))
            tn = getattr(tgcl, name)(tgcl.Term(ta), tgcl.Term(tb))
            assert getattr(tn, method)(k) == getattr(jn, method)(k), \
                f"{name}.{method}({k})"


@settings(max_examples=40, deadline=None)
@given(lists=st.lists(gc_list_strategy, min_size=0, max_size=5))
def test_balanced_trees_and_sugar(lists):
    pairs = [_lists(ivs) for ivs in lists]
    for jf, tf in ((jgcl.one_of_all, tgcl.one_of_all),
                   (jgcl.both_of_all, tgcl.both_of_all)):
        want = jf([jgcl.Term(j) for j, _ in pairs]).solutions()
        got = tf([tgcl.Term(t) for _, t in pairs]).solutions()
        assert got == want
    if len(pairs) >= 2:
        (ja, ta), (jb, tb) = pairs[:2]
        jA, jB, tA, tB = (jgcl.Term(ja), jgcl.Term(jb), tgcl.Term(ta),
                          tgcl.Term(tb))
        for op in ("__and__", "__or__", "__rshift__", "__lt__", "__gt__"):
            assert (getattr(tA, op)(tB).solutions()
                    == getattr(jA, op)(jB).solutions()), op


def test_sentinels_are_the_reference_values():
    assert (INF, NINF) == (jcore.INF, jcore.NINF)
    empty = tgcl.Term(treduce(np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros(0)))
    node = tgcl.BothOf(empty, empty)
    assert node.tau(0)[1] >= INF and node.rho_b(0)[0] <= NINF


# ------------------------------------------------------------------ #
# the query language over both packages' JSON stores
# ------------------------------------------------------------------ #
QUERIES = [
    '[:city:] >> "new york" << [Files/zips.json]',
    "[:title:] | [:authors:] << [Files/books.json]",
    "([:name:] & [:cuisine:]) << [Files/restaurant.json]",
    '"company" ... "nanotech"',
    "[:name:] !<< [Files/restaurant.json]",
    "[:name:] << [Files/restaurant.json]",
    "[:] !>> [:pop:]",
    "[:] >> ([:pop:] | [:rating:])",
    "nanotech",
    "[:]",
    "[:description:] >> (software ... web)",
]


@pytest.fixture(scope="module")
def warrens():
    """Both packages' warrens over the same JSON objects."""
    out = []
    for core, data in ((jcore, jjson_collection(seed=0, scale=0.4)),
                       (tcore, json_collection(seed=0, scale=0.4))):
        w = core.Warren(core.DynamicIndex())
        with w:
            w.transaction()
            for name, objs in data.items():
                for obj in objs:
                    core.add_json(w, obj, collection=f"Files/{name}.json")
            w.commit()
        out.append(w)
    return out


@pytest.mark.parametrize("text", QUERIES)
def test_query_language_matches_reference(warrens, text):
    jw, tw = warrens
    with jw, tw:
        want = jquery.solve(text, jw)
        got = tquery.solve(text, tw)
        assert got == want
        assert tquery.parse_query(text, tw).solutions() \
            == jquery.parse_query(text, jw).solutions()
    assert want, "every query has solutions at this scale"


def test_query_language_limit_and_errors(warrens):
    _, tw = warrens
    with tw:
        assert len(tquery.solve("[:]", tw, limit=7)) == 7
        for bad in ("[:a:] <<", "(unclosed", '"unclosed phrase', "a ~ b"):
            with pytest.raises(tquery.QueryError):
                tquery.parse_query(bad, tw)
