"""The port's dense scorer and top-k against the reference package's.

``bm25_topk`` on the CPU must give the reference scores bit for bit and the
same ids in the same order, ties included; ``stable_topk`` must order like
a stable descending sort.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import vectorized as jvec
from repro_torch.core import vectorized as tvec


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
    rng = np.random.default_rng(n)
    x = rng.choice(np.array([-np.inf, -2.5, -0.0, 0.0, 1.0, 1.0 + 2**-23,
                             3.0, np.inf], np.float32), size=(3, n))
    x[1] = rng.standard_normal(n).astype(np.float32)
    vals, idx = tvec.stable_topk(torch.from_numpy(x), k)
    for r in range(3):
        # stable descending sort; -0.0 ranks with +0.0
        order = np.argsort(-(x[r] + np.float32(0.0)), kind="stable")[:k]
        np.testing.assert_array_equal(idx[r].numpy(), order)
        np.testing.assert_array_equal(vals[r].numpy(), x[r][order])


def test_stable_topk_matches_lax_top_k_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0, 0.0]], np.float32)
    jv, ji = __import__("jax").lax.top_k(jnp.asarray(x), 6)
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
