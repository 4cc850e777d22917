"""Learned sparse retrieval over annotations (paper §2.2).

"Annotative indexing trivially supports learned sparse retrieval by
creating an annotation for each element of a sparse vector" — here:

  ⟨w:<method>:<token>, (p, p), weight⟩       at the scored extent's start

Multiple methods coexist in one index (e.g. BM25 tf: at the document level
and SPLADE-style w:splade: at the passage level), and hybrid scoring is a
weighted sum over the same τ/ρ machinery.  Since learned weights lack the
distributional properties WAND exploits (paper's own caveat), scoring here
is score-at-a-time over the impact layout — which is exactly the
bm25_blockmax kernel's input format, so the device path is shared.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .annotation import AnnotationList

W_PREFIX = "w:"


def index_sparse_vector(w, extent: Tuple[int, int], weights: Dict[str, float],
                        method: str = "splade") -> int:
    """Annotate ⟨w:method:token, extent.start, weight⟩ per nonzero."""
    lo = extent[0]
    n = 0
    for token, weight in weights.items():
        if weight != 0.0:
            w.annotate(f"{W_PREFIX}{method}:{token}", lo, lo, float(weight))
            n += 1
    return n


def score_sparse(reader, query_weights: Dict[str, float], k: int = 10,
                 method: str = "splade",
                 extents: Optional[AnnotationList] = None
                 ) -> List[Tuple[int, float]]:
    """Dot product between the query vector and indexed sparse vectors.

    `extents` (default: ':' extents) defines the scored units; impact lists
    are keyed at extent starts, so scoring is a merge over starts — the same
    access pattern as BM25 and the same device layout."""
    extents = extents if extents is not None else reader.annotations(":")
    if len(extents) == 0:
        return []
    starts = extents.starts
    acc = np.zeros(len(starts))
    for token, qw in query_weights.items():
        lst = reader.annotations(f"{W_PREFIX}{method}:{token}")
        if len(lst) == 0:
            continue
        idx = np.searchsorted(starts, lst.starts)
        idx = np.clip(idx, 0, len(starts) - 1)
        ok = starts[idx] == lst.starts
        np.add.at(acc, idx[ok], qw * lst.values[ok])
    kk = min(k, len(starts))
    top = np.argpartition(-acc, kk - 1)[:kk]
    top = top[np.argsort(-acc[top], kind="stable")]
    return [(int(starts[i]), float(acc[i])) for i in top if acc[i] > 0]


def score_hybrid(reader, query: str, query_weights: Dict[str, float],
                 k: int = 10, alpha: float = 0.5,
                 method: str = "splade") -> List[Tuple[int, float]]:
    """alpha·BM25 + (1-alpha)·sparse, both from the same index."""
    from .ranking import collection_stats, score_bm25
    stats = collection_stats(reader)
    bm = dict(score_bm25(reader, query, k=max(k * 4, 50), stats=stats))
    sp = dict(score_sparse(reader, query_weights, k=max(k * 4, 50),
                           method=method))
    def norm(d):
        if not d:
            return {}
        m = max(d.values()) or 1.0
        return {doc: v / m for doc, v in d.items()}
    bm, sp = norm(bm), norm(sp)
    docs = set(bm) | set(sp)
    fused = {d: alpha * bm.get(d, 0.0) + (1 - alpha) * sp.get(d, 0.0)
             for d in docs}
    out = sorted(fused.items(), key=lambda kv: -kv[1])[:k]
    return [(d, s) for d, s in out]
