"""Plain PyTorch versions: exhaustive BM25 over the block-impact layout, and
the pruned sweep the CUDA kernel computes.

Every sum over terms here runs serially in term order from 0.0, as the
kernel does, so the plain sweep and the kernel agree bit for bit.
"""

import torch

from repro_torch.core.vectorized import stable_topk


def term_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 serially, t = 0, 1, …, starting from 0.0."""
    out = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for t in range(x.shape[0]):
        out += x[t]
    return out


def bm25_score_ref(impacts: torch.Tensor) -> torch.Tensor:
    """impacts [T, NB, BS] → scores [NB * BS] (sum over terms, no pruning)."""
    return term_sum(impacts).reshape(-1)


def bm25_topk_ref(impacts: torch.Tensor, k: int):
    return stable_topk(bm25_score_ref(impacts), k)


def blockmax_scores(impacts: torch.Tensor, block_max: torch.Tensor,
                    theta: torch.Tensor) -> torch.Tensor:
    """impacts [T, NB, BS], block_max [T, NB], theta [1] → scores [NB, BS]
    with the blocks whose upper bound is below theta set to -inf."""
    ub = term_sum(block_max)                                   # [NB]
    keep = (ub >= theta.reshape(())).unsqueeze(1)              # [NB, 1]
    return torch.where(keep, term_sum(impacts),
                       torch.tensor(float("-inf"), device=impacts.device))
