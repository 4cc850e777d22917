"""The port's device algebra against the reference package's.

``bm25_topk`` on the CPU must give the reference scores bit for bit and the
same ids in the same order, ties included; ``stable_topk`` must order like
``jax.lax.top_k`` (a stable descending sort with -0.0 below +0.0).  The
GCL array algebra (τ/ρ, G-reduction, the containment and combination
operators) must give the reference's int32
outputs bit for bit and its values exactly, on the property-test lists of
the reference's ``tests/test_vectorized.py``, and the lazy engine's
solutions.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import vectorized as jvec
from repro_torch.core import gcl
from repro_torch.core import vectorized as tvec
from repro_torch.core.annotation import AnnotationList, reduce_minimal


def _batch(seed, q, t, l, n_docs, fill, tie_levels):
    """Padded (doc_idx, impacts, qmask): unique docs per (q, t) row, impacts
    drawn from a few levels so many documents tie exactly."""
    rng = np.random.default_rng(seed)
    doc_idx = np.full((q, t, l), n_docs, np.int32)
    impacts = np.zeros((q, t, l), np.float32)
    levels = rng.random(tie_levels).astype(np.float32) * 3
    for qi in range(q):
        for ti in range(t):
            n = int(rng.integers(0, int(l * fill) + 1))
            doc_idx[qi, ti, :n] = rng.choice(n_docs, size=n, replace=False)
            impacts[qi, ti, :n] = rng.choice(levels, size=n)
    qmask = (rng.random((q, t)) < 0.8).astype(np.float32)
    return doc_idx, impacts, qmask


@pytest.mark.parametrize("q,t,l,n_docs,k,tie_levels", [
    (4, 8, 256, 4096, 10, 3),        # heavy ties across the whole row
    (3, 2, 64, 128, 128, 2),         # k = n_docs: the full tie order
    (2, 4, 256, 1024, 25, 50),
    (1, 1, 8, 16, 10, 1),            # fewer positive docs than k
])
def test_bm25_topk_bitwise_equal(q, t, l, n_docs, k, tie_levels):
    doc_idx, impacts, qmask = _batch(q * 7 + t, q, t, l, n_docs, 0.9,
                                     tie_levels)
    want_s, want_i = jvec.bm25_topk(jnp.asarray(doc_idx),
                                    jnp.asarray(impacts),
                                    jnp.asarray(qmask), n_docs=n_docs, k=k)
    got_s, got_i = tvec.bm25_topk(torch.from_numpy(doc_idx),
                                  torch.from_numpy(impacts),
                                  torch.from_numpy(qmask), n_docs=n_docs, k=k)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_bm25_topk_padding_never_scores():
    """Rows that are all padding score 0 everywhere, at the lowest ids."""
    doc_idx = np.full((2, 2, 16), 32, np.int32)
    impacts = np.zeros((2, 2, 16), np.float32)
    qmask = np.ones((2, 2), np.float32)
    s, i = tvec.bm25_topk(torch.from_numpy(doc_idx),
                          torch.from_numpy(impacts),
                          torch.from_numpy(qmask), n_docs=32, k=5)
    assert s.eq(0).all()
    assert i.tolist() == [[0, 1, 2, 3, 4]] * 2


@pytest.mark.parametrize("n,k", [(1, 1), (50, 7), (1000, 1000), (4097, 33)])
def test_stable_topk_matches_stable_sort(n, k):
    """Values descending, ties by the lower index, -0.0 below +0.0: the
    order of ``jax.lax.top_k`` on the same rows."""
    rng = np.random.default_rng(n)
    x = rng.choice(np.array([-np.inf, -2.5, -0.0, 0.0, 1.0, 1.0 + 2**-23,
                             3.0, np.inf], np.float32), size=(3, n))
    x[1] = rng.standard_normal(n).astype(np.float32)
    vals, idx = tvec.stable_topk(torch.from_numpy(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_stable_topk_signed_zeros_infinities_subnormals(seed):
    """Rows drawn from ±0.0, ±1, ±inf and the ±smallest subnormals: the
    indices and the value bits equal ``lax.top_k``'s, row by row."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-45, -1e-45,
                     2e-45], np.float32)
    x = rng.choice(pool, size=(100, 50)).astype(np.float32)
    x[0] = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0] * 8 + [0.0, -0.0],
                    np.float32)
    for k in (1, 20, 50):
        vals, idx = tvec.stable_topk(torch.from_numpy(x), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                      np.asarray(want_v).view(np.int32))
    assert tvec.stable_topk(torch.from_numpy(x[:1, :6]), 6)[1].tolist() \
        == [[4, 0, 2, 1, 3, 5]]


def test_stable_topk_matches_lax_top_k_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tvec.stable_topk(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_stable_topk_rejects_bad_k():
    with pytest.raises(ValueError):
        tvec.stable_topk(torch.zeros(4), 5)
    with pytest.raises(TypeError):
        tvec.stable_topk(torch.zeros(4, dtype=torch.float64), 2)


@pytest.mark.parametrize("size", [None, 9])
def test_pack_unpack_match_reference(size):
    starts = np.array([3, 7, 11, 20], np.int64)
    ends = starts + 2
    vals = np.array([0.5, 1.5, 2.5, 3.5])
    want = [np.asarray(a) for a in jvec.pack(starts, ends, vals, size=size)]
    got = tvec.pack(starts, ends, vals, size=size, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    for w, g in zip(jvec.unpack(*want), tvec.unpack(*got)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ #
# the GCL array algebra
# ------------------------------------------------------------------ #
gc_strategy = st.lists(
    st.tuples(st.integers(0, 60), st.integers(0, 10), st.integers(0, 4))
    .map(lambda t: (t[0], t[0] + t[1], t[2] / 4)),
    max_size=16,
)


def _gc(ivs):
    if not ivs:
        return AnnotationList.empty()
    s = np.array([i[0] for i in ivs], dtype=np.int64)
    e = np.array([i[1] for i in ivs], dtype=np.int64)
    return reduce_minimal(s, e, np.array([i[2] for i in ivs]))


CONTAINMENT = ["contained_in", "containing", "not_contained_in",
               "not_containing"]
COMBINATION = ["both_of", "one_of", "followed_by"]
LAZY = {"contained_in": gcl.ContainedIn, "containing": gcl.Containing,
        "not_contained_in": gcl.NotContainedIn,
        "not_containing": gcl.NotContaining, "both_of": gcl.BothOf,
        "one_of": gcl.OneOf, "followed_by": gcl.FollowedBy}


def _same(got, want):
    """Bit-equal: the same dtype and the same bits, element for element."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("name", CONTAINMENT + COMBINATION)
@settings(max_examples=30, deadline=None)
@given(a=gc_strategy, b=gc_strategy)
def test_gcl_operator_bit_equal_to_reference(name, a, b):
    A, B = _gc(a), _gc(b)
    ja, jb = jvec.pack(A.starts, A.ends, A.values), jvec.pack(B.starts, B.ends)
    ta = tvec.pack(A.starts, A.ends, A.values)
    tb = tvec.pack(B.starts, B.ends)
    if name in CONTAINMENT:
        want = getattr(jvec, name)(*ja, *jb[:2])
        got = getattr(tvec, name)(*ta, *tb[:2])
    else:
        want = getattr(jvec, name)(*ja[:2], *jb[:2])
        got = getattr(tvec, name)(*ta[:2], *tb[:2])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
    lazy = LAZY[name](gcl.Term(A), gcl.Term(B)).solutions()
    s, e, v = tvec.unpack(*got) if name in CONTAINMENT else \
        tvec.unpack(*got[:2])
    assert sorted(zip(s.tolist(), e.tolist())) == [(p, q) for p, q, _ in lazy]
    if name in CONTAINMENT:        # values ride along exactly
        assert v.tolist() == [np.float32(x) for _, _, x in lazy]


@pytest.mark.parametrize("name", ["contained_in_mask", "containing_mask"])
@settings(max_examples=25, deadline=None)
@given(a=gc_strategy, b=gc_strategy)
def test_containment_mask_bit_equal_to_reference(name, a, b):
    A, B = _gc(a), _gc(b)
    want = getattr(jvec, name)(*jvec.pack(A.starts, A.ends)[:2],
                               *jvec.pack(B.starts, B.ends)[:2])
    got = getattr(tvec, name)(*tvec.pack(A.starts, A.ends)[:2],
                              *tvec.pack(B.starts, B.ends)[:2])
    _same(got, want)


@settings(max_examples=25, deadline=None)
@given(a=gc_strategy)
def test_tau_rho_bit_equal_to_reference(a):
    A = _gc(a)
    js, je, _ = jvec.pack(A.starts, A.ends)
    ts, te, _ = tvec.pack(A.starts, A.ends)
    ks = np.arange(-2, 75)
    for fn in ("tau", "rho"):
        for g, w in zip(getattr(tvec, fn)(ts, te, ks),
                        getattr(jvec, fn)(js, je, ks)):
            _same(g, w)
    term = gcl.Term(A)
    for i, k in enumerate(ks):
        for fn in ("tau", "rho"):
            s, e = (x[i] for x in getattr(tvec, fn)(ts, te, ks))
            want = getattr(term, fn)(int(k))
            if want[1] >= gcl.INF:
                assert int(s) == tvec.PAD
            else:
                assert (int(s), int(e)) == want[:2]


@settings(max_examples=25, deadline=None)
@given(a=gc_strategy, b=gc_strategy)
def test_g_reduce_mask_bit_equal_to_reference(a, b):
    """Unreduced candidates with duplicates and nesting, PAD mixed in."""
    ivs = [(p, q) for p, q, _ in a + b]
    s = np.array([p for p, _ in ivs] + [int(jvec.PAD)] * 3, np.int32)
    e = np.array([q for _, q in ivs] + [int(jvec.PAD)] * 3, np.int32)
    perm = np.random.default_rng(len(ivs)).permutation(len(s))
    s, e = s[perm], e[perm]
    want = jvec.g_reduce_mask(jnp.asarray(s), jnp.asarray(e))
    got = tvec.g_reduce_mask(torch.from_numpy(s), torch.from_numpy(e))
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_followed_by_keeps_int32_at_pad():
    s, e, _ = tvec.pack([0, 5], [1, 6], size=4)
    out = tvec.followed_by(s, e, s, e)
    assert all(x.dtype == torch.int32 for x in out)
    assert int(out[0][0]) == 0 and int(out[1][0]) == 6


@pytest.mark.parametrize("name", COMBINATION)
@settings(max_examples=25, deadline=None)
@given(a=gc_strategy, b=gc_strategy, x=gc_strategy)
def test_compact_makes_combination_a_containment_b(name, a, b, x):
    """A combination's output, compacted, is a GC-list: its valid entries
    in the same order, PAD at the tail, and the containment operators on
    it as B give the lazy engine's answers."""
    A, B, X = _gc(a), _gc(b), _gc(x)
    ta, tb = tvec.pack(A.starts, A.ends), tvec.pack(B.starts, B.ends)
    out = getattr(tvec, name)(*ta[:2], *tb[:2])
    c_s, c_e = tvec.compact(*out)
    n = int((out[0] != tvec.PAD).sum())
    assert bool((c_s[n:] == tvec.PAD).all())
    for g, w in zip(tvec.unpack(c_s, c_e)[:2], tvec.unpack(*out)[:2]):
        np.testing.assert_array_equal(g, w)
    tx = tvec.pack(X.starts, X.ends, X.values)
    comb = LAZY[name](gcl.Term(A), gcl.Term(B))
    for op in ("contained_in", "containing"):
        s, e, _ = tvec.unpack(*getattr(tvec, op)(*tx, c_s, c_e))
        lazy = LAZY[op](gcl.Term(X), comb).solutions()
        assert list(zip(s.tolist(), e.tolist())) == [(p, q)
                                                     for p, q, _ in lazy]
