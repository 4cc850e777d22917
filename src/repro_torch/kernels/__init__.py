"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel subpackage ships kernel.py (the wrapper: checks, launch, launch
count) and ref.py (the plain version, which CPU tensors take):

- ``bm25_blockmax``, the block-max pruned BM25 sweep of ranked retrieval;
  it also has ops.py, the top-k built around its kernel;
- ``interval_join``, the GC-list containment mask of structured retrieval;
  its operation is ``core.vectorized.contained_in_mask`` /
  ``containing_mask``, which call the wrapper;
- ``gqa_decode``, split-KV flash-decoding attention of LM decode;
  ``models.transformer.decode_step`` calls the wrapper once per layer;
- ``embedding_bag``, the fused gather and weighted sum of recsys; it also
  has ops.py (``embedding_bag_padded``, through which every table lookup
  of ``models.recsys`` goes, and ``pad_ragged``).

Sources live in ``repro_torch/csrc`` and are built by
:mod:`repro_torch.kernels.build` at first use.
"""

from .bm25_blockmax import (blockmax_scores, bm25_blockmax_topk,
                            bm25_score_ref, bm25_topk_ref, pruned_fraction)
from .embedding_bag import (embedding_bag, embedding_bag_padded,
                            embedding_bag_ref, pad_ragged)
from .gqa_decode import gqa_decode, gqa_decode_ref
from .interval_join import (contained_in_mask_ref, containing_mask_ref,
                            interval_join)

__all__ = ["blockmax_scores", "bm25_blockmax_topk", "bm25_score_ref",
           "bm25_topk_ref", "pruned_fraction", "contained_in_mask_ref",
           "containing_mask_ref", "embedding_bag", "embedding_bag_padded",
           "embedding_bag_ref", "gqa_decode", "gqa_decode_ref",
           "interval_join", "pad_ragged"]
