"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel subpackage ships kernel.py (the wrapper: checks, launch, launch
count) and ref.py (the plain version, which CPU tensors take);
bm25_blockmax also has ops.py, the top-k built around its kernel.
interval_join's operation is ``core.vectorized.contained_in_mask`` /
``containing_mask``, which call the wrapper.  Sources live in ``repro_torch/csrc`` and
are built by :mod:`repro_torch.kernels.build` at first use.
"""

from .bm25_blockmax import (blockmax_scores, bm25_blockmax_topk,
                            bm25_score_ref, bm25_topk_ref, pruned_fraction)
from .interval_join import (contained_in_mask_ref, containing_mask_ref,
                            interval_join)

__all__ = ["blockmax_scores", "bm25_blockmax_topk", "bm25_score_ref",
           "bm25_topk_ref", "pruned_fraction", "contained_in_mask_ref",
           "containing_mask_ref", "interval_join"]
