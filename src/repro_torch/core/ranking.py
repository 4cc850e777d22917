"""Ranked retrieval over an annotative index (paper §2.2, Fig. 7 workload).

Annotation conventions (exactly the paper's):

  ⟨:, (d_lo, d_hi)⟩                  document extent (feature ":")
  ⟨tf:porter:<stem>, d_lo, tf⟩       per-document term frequency
  ⟨dl:, d_lo, len⟩                   document length in ranking tokens
  ⟨<word>, a⟩                        word occurrence (added by append)

The *index* only stores annotations; this module interprets them as BM25
(Robertson et al. 1994).  Query evaluation offers two host strategies:

  score_bm25        exhaustive merge-join over tf lists (numpy, float64)
  score_blockmax    Block-Max: per-block maxima prune whole blocks (the
                    block-impact layout also feeds the bm25_blockmax kernel)
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .annotation import AnnotationList
from .stemmer import porter_stem

_WORD_RE = re.compile(r"\w+", re.UNICODE)

TF_PREFIX = "tf:porter:"
DOC_FEATURE = ":"
DL_FEATURE = "dl:"

def ranking_tokens(text: str) -> List[str]:
    return [w.lower() for w in _WORD_RE.findall(text)]


def index_document(txn_or_warren, text: str, docid: str = None,
                   extra_annotations: Sequence[Tuple[str, float]] = ()) -> Tuple[int, int]:
    """Append a document and add the ranking annotations above."""
    w = txn_or_warren
    lo, hi = w.append(text)
    w.annotate(DOC_FEATURE, lo, hi)
    words = ranking_tokens(text)
    stems: Dict[str, int] = {}
    for word in words:
        s = porter_stem(word)
        stems[s] = stems.get(s, 0) + 1
    for stem, tf in stems.items():
        w.annotate(TF_PREFIX + stem, lo, lo, float(tf))
    w.annotate(DL_FEATURE, lo, lo, float(len(words)))
    if docid is not None:
        w.annotate("docid:" + docid, lo, hi)
    for feature, value in extra_annotations:
        w.annotate(feature, lo, lo, value)
    return lo, hi


def ingest_documents(warren, docs, batch: int = 64) -> int:
    """Index ``(docid, text)`` pairs in chunked transactions.

    One transaction per chunk matters for a ShardedWarren: all appends of
    a transaction land on one shard group (routed by the first document),
    so chunking is what spreads a corpus across groups.  Returns the
    number of documents ingested."""
    n = 0
    it = iter(docs)
    while True:
        chunk = [d for _, d in zip(range(batch), it)]
        if not chunk:
            return n
        with warren:
            warren.transaction()
            for docid, text in chunk:
                index_document(warren, text, docid=docid)
            warren.commit()
        n += len(chunk)


@dataclass
class CollectionStats:
    n_docs: int
    avgdl: float
    doc_starts: np.ndarray   # sorted starts of ':' extents
    doc_ends: np.ndarray
    doc_lens: np.ndarray     # aligned with doc_starts


def collection_stats(snapshot_or_warren) -> CollectionStats:
    docs = snapshot_or_warren.annotations(DOC_FEATURE)
    dls = snapshot_or_warren.annotations(DL_FEATURE)
    lens = np.ones(len(docs))
    if len(dls):
        idx = np.searchsorted(dls.starts, docs.starts)
        idx = np.clip(idx, 0, len(dls) - 1)
        hit = dls.starts[idx] == docs.starts
        lens = np.where(hit, dls.values[idx], 1.0)
    avgdl = float(lens.mean()) if len(docs) else 1.0
    return CollectionStats(len(docs), avgdl, docs.starts.copy(),
                           docs.ends.copy(), lens)


def _term_lists(snapshot_or_warren, terms: Sequence[str]):
    return {t: snapshot_or_warren.annotations(TF_PREFIX + porter_stem(t))
            for t in terms}


def _bm25_idf(n_docs: int, df: int) -> float:
    return float(np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)))


def _impacts(lst: AnnotationList, stats: CollectionStats,
             idf: float, k1: float, b: float) -> Tuple[np.ndarray, np.ndarray]:
    """(doc_index, impact) pairs for one term's tf list."""
    di = np.searchsorted(stats.doc_starts, lst.starts)
    di = np.clip(di, 0, max(len(stats.doc_starts) - 1, 0))
    ok = (len(stats.doc_starts) > 0) & (stats.doc_starts[di] == lst.starts)
    di, tf = di[ok], lst.values[ok]
    dl = stats.doc_lens[di]
    denom = tf + k1 * (1.0 - b + b * dl / stats.avgdl)
    return di, idf * tf * (k1 + 1.0) / denom


def _impacts_with_avgdl(lst: AnnotationList, stats: CollectionStats,
                        idf: float, avgdl: float, k1: float = 0.9,
                        b: float = 0.4) -> Tuple[np.ndarray, np.ndarray]:
    """``_impacts`` with the collection's avgdl overridden — scatter-gather
    serving scores each shard's documents against the GLOBAL average, and
    every path sharing this helper is what keeps sharded results
    bit-identical to the single index."""
    local = CollectionStats(stats.n_docs, avgdl, stats.doc_starts,
                            stats.doc_ends, stats.doc_lens)
    return _impacts(lst, local, idf, k1, b)


def score_bm25(snapshot_or_warren, query: str, k: int = 10,
               k1: float = 0.9, b: float = 0.4,
               weights: Optional[Dict[str, float]] = None,
               stats: Optional[CollectionStats] = None) -> List[Tuple[int, float]]:
    """Exhaustive BM25; returns [(doc_start_address, score)] best-first."""
    stats = stats or collection_stats(snapshot_or_warren)
    if stats.n_docs == 0:
        return []
    terms = ranking_tokens(query) if weights is None else list(weights)
    lists = _term_lists(snapshot_or_warren, terms)
    acc = np.zeros(stats.n_docs)
    for t in set(terms):
        lst = lists[t]
        if len(lst) == 0:
            continue
        idf = _bm25_idf(stats.n_docs, len(lst))
        wq = 1.0 if weights is None else float(weights[t])
        di, imp = _impacts(lst, stats, idf, k1, b)
        np.add.at(acc, di, wq * imp)
    k = min(k, stats.n_docs)
    top = np.argpartition(-acc, k - 1)[:k]
    top = top[np.argsort(-acc[top], kind="stable")]
    return [(int(stats.doc_starts[i]), float(acc[i])) for i in top if acc[i] > 0]


# --------------------------------------------------------------------- #
# Block-Max layout: doc space cut into fixed blocks; per-(term, block)
# maxima enable block skipping (Ding & Suel 2011).  This same layout feeds
# the bm25_blockmax device kernel (kernels/bm25_blockmax).
# --------------------------------------------------------------------- #
@dataclass
class BlockImpactIndex:
    block_size: int
    n_docs: int
    n_blocks: int
    terms: List[str]
    # per term: (block_ids, block_offsets_into doc/imp arrays, doc_idx, impacts, block_max)
    term_blocks: List[dict]
    doc_starts: np.ndarray


def build_block_impacts(snapshot_or_warren, terms: Sequence[str],
                        block_size: int = 128, k1: float = 0.9, b: float = 0.4,
                        stats: Optional[CollectionStats] = None) -> BlockImpactIndex:
    stats = stats or collection_stats(snapshot_or_warren)
    n_blocks = max(1, -(-stats.n_docs // block_size))
    lists = _term_lists(snapshot_or_warren, terms)
    tb = []
    kept_terms = []
    for t in terms:
        lst = lists[t]
        if len(lst) == 0:
            continue
        idf = _bm25_idf(stats.n_docs, len(lst))
        di, imp = _impacts(lst, stats, idf, k1, b)
        blk = di // block_size
        uniq, starts_in = np.unique(blk, return_index=True)
        bmax = np.maximum.reduceat(imp, starts_in) if len(imp) else np.zeros(0)
        tb.append({"blocks": uniq.astype(np.int64),
                   "offsets": np.append(starts_in, len(di)).astype(np.int64),
                   "di": di.astype(np.int64), "imp": imp,
                   "bmax": bmax})
        kept_terms.append(t)
    return BlockImpactIndex(block_size, stats.n_docs, n_blocks, kept_terms,
                            tb, stats.doc_starts.copy())


def score_blockmax(bidx: BlockImpactIndex, k: int = 10) -> List[Tuple[int, float]]:
    """Block-Max scoring over the block-impact layout (host reference)."""
    if not bidx.term_blocks:
        return []
    # per-block upper bound = sum over terms of that block's max impact
    ub = np.zeros(bidx.n_blocks)
    for t in bidx.term_blocks:
        ub[t["blocks"]] += t["bmax"]
    order = np.argsort(-ub, kind="stable")     # best blocks first
    heap: List[Tuple[float, int]] = []
    theta = 0.0
    bs = bidx.block_size
    scores = np.zeros(bs)
    for blk in order:
        if len(heap) >= k and ub[blk] <= theta:
            break                              # all remaining blocks pruned
        scores[:] = 0.0
        for t in bidx.term_blocks:
            j = int(np.searchsorted(t["blocks"], blk))
            if j < len(t["blocks"]) and t["blocks"][j] == blk:
                lo, hi = t["offsets"][j], t["offsets"][j + 1]
                np.add.at(scores, t["di"][lo:hi] - blk * bs, t["imp"][lo:hi])
        base = blk * bs
        for i in np.flatnonzero(scores):
            s = float(scores[i])
            d = int(base + i)
            if len(heap) < k:
                heapq.heappush(heap, (s, d))
            elif s > heap[0][0]:
                heapq.heapreplace(heap, (s, d))
        if len(heap) >= k:
            theta = heap[0][0]
    out = sorted(heap, key=lambda x: -x[0])
    return [(int(bidx.doc_starts[d]), s) for s, d in out if s > 0]
