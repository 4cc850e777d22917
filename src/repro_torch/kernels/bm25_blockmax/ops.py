"""Block-Max BM25 top-k: θ pre-pass, pruned kernel sweep, final top-k."""

import torch

from repro_torch.core.vectorized import stable_topk

from .kernel import blockmax_scores
from .ref import term_sum


def blockmax_threshold(impacts: torch.Tensor, block_max: torch.Tensor,
                       k: int, probe_blocks: int = None) -> torch.Tensor:
    """θ pre-pass: exactly score the highest-UB blocks and return the k-th
    best of those scores as a one-element tensor on the device.

    θ is the k-th best score over a SUBSET of documents, so it is ≤ the
    true k-th best and pruning on it is safe.  It never visits the host,
    so nothing waits between the pre-pass and the sweep.
    """
    _, nb, bs = impacts.shape
    probe = min(nb, probe_blocks or max(1, -(-k // bs) * 2))
    ub = term_sum(block_max)                                   # [NB]
    _, best_blocks = stable_topk(ub, probe)
    probe_scores = term_sum(impacts[:, best_blocks, :]).reshape(-1)
    kk = min(k, probe * bs)
    return stable_topk(probe_scores, kk)[0][kk - 1:kk]        # [1]


def bm25_blockmax_topk(impacts: torch.Tensor, block_max: torch.Tensor,
                       k: int, probe_blocks: int = None):
    """Top-k docs by BM25 with block-max pruning, on the tensors' device.

    impacts    [T, NB, BS] dense block-impact layout (0 where term absent)
    block_max  [T, NB]     per-(term, block) maxima
    Returns (scores [k'], flat_doc_ids [k']) with k' = min(k, NB * BS);
    exact, because the pruning is conservative.  Ties order by lower id.
    """
    t, nb, bs = impacts.shape
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if nb * bs == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=impacts.device)
        return empty, torch.zeros(0, dtype=torch.int64, device=impacts.device)
    theta = blockmax_threshold(impacts, block_max, k, probe_blocks)
    scores = blockmax_scores(impacts, block_max, theta)        # [NB, BS]
    # pruned blocks carry -inf; clamp to the true score floor (impacts are
    # non-negative) so a top-k that spills past the last positive doc reads
    # 0 exactly like the exhaustive oracle
    scores = scores.clamp_min_(0.0)
    return stable_topk(scores.reshape(-1), min(k, nb * bs))


def pruned_fraction(block_max: torch.Tensor, theta) -> torch.Tensor:
    """Diagnostic: fraction of blocks the kernel skips at threshold θ."""
    return (term_sum(block_max) < theta).to(torch.float32).mean()
