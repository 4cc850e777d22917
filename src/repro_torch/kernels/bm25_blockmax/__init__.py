from .kernel import blockmax_scores
from .ops import blockmax_threshold, bm25_blockmax_topk, pruned_fraction
from .ref import bm25_score_ref, bm25_topk_ref

__all__ = ["blockmax_threshold", "bm25_blockmax_topk", "pruned_fraction",
           "blockmax_scores",
           "bm25_score_ref", "bm25_topk_ref"]
