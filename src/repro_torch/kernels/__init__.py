"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel subpackage ships kernel.py (the wrapper: checks, launch, launch
count), ops.py (the operation built around it) and ref.py (the plain
version, which CPU tensors take).  Sources live in ``repro_torch/csrc`` and
are built by :mod:`repro_torch.kernels.build` at first use.
"""

from .bm25_blockmax import (blockmax_scores, bm25_blockmax_topk,
                            bm25_score_ref, bm25_topk_ref, pruned_fraction)

__all__ = ["blockmax_scores", "bm25_blockmax_topk", "bm25_score_ref",
           "bm25_topk_ref", "pruned_fraction"]
