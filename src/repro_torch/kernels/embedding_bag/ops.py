"""EmbeddingBag as the models call it, with its gradient, and the ragged →
padded adapter (``src/repro/kernels/embedding_bag/ops.py``)."""

import numpy as np
import torch

from . import kernel


def embedding_bag_padded(table: torch.Tensor, indices: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Padded-bag lookup: table [V, D]; indices [B, L] (0-padded); weights
    [B, L] (0 on padding) → [B, D] in the table's dtype.  Indices become
    int32 and weights float32, as the Pallas wrapper casts them; the
    kernels' wrappers then launch on the card and take the plain versions
    on the CPU (there is no switch).  The table's gradient, where autograd
    asks for one, is the backward kernel's (the operator's
    ``register_autograd``; indices and weights get none); weights that
    require a gradient are refused (no model trains its bag weights)."""
    if weights.requires_grad:
        raise ValueError("bag weights that require a gradient are not "
                         "supported: the backward gives the table's only")
    return kernel.embedding_bag(
        table, indices.to(torch.int32).contiguous(),
        weights.to(torch.float32).contiguous())


def pad_ragged(indices: np.ndarray, offsets: np.ndarray, max_bag: int):
    """Host adapter: CSR-style ragged bags → padded [B, max_bag] + weights."""
    b = len(offsets) - 1
    out = np.zeros((b, max_bag), dtype=np.int32)
    w = np.zeros((b, max_bag), dtype=np.float32)
    for i in range(b):
        lo, hi = offsets[i], min(offsets[i + 1], offsets[i] + max_bag)
        n = hi - lo
        out[i, :n] = indices[lo:hi]
        w[i, :n] = 1.0
    return out, w
