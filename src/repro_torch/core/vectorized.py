"""Batched device scoring: the dense BM25 scorer and an exact top-k.

Padding convention: GC-list entries with start == PAD (= int32 max) are
invalid.  The GCL array algebra (batched τ/ρ, containment masks,
combination operators) is not part of this package yet; what the retrieval
path needs is here:

* :func:`stable_topk` — top-k with the tie order of ``jax.lax.top_k``
  (values descending, equal values by lower index), which the server's
  result order and any later k-way merge rely on.  ``torch.topk`` alone
  does not promise an order among ties.
* :func:`bm25_topk` — the dense scatter-add scorer the server calls once
  per micro-batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PAD = np.int32(np.iinfo(np.int32).max)


def pack(starts, ends, values=None, size: int = None, device=None):
    """Host → device: pad a GC-list to `size` entries."""
    n = len(starts)
    size = size or max(n, 1)
    s = np.full(size, PAD, dtype=np.int32)
    e = np.full(size, PAD, dtype=np.int32)
    v = np.zeros(size, dtype=np.float32)
    s[:n] = starts
    e[:n] = ends
    if values is not None:
        v[:n] = values
    return (torch.from_numpy(s).to(device), torch.from_numpy(e).to(device),
            torch.from_numpy(v).to(device))


def unpack(s, e, v=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    s, e = s.cpu().numpy(), e.cpu().numpy()
    keep = s != PAD
    vv = v.cpu().numpy()[keep] if v is not None else np.zeros(keep.sum())
    return s[keep], e[keep], vv


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim of a float32 tensor: values descending,
    ties broken by the lower index — the order a stable descending sort
    gives, computed without sorting the row.

    Each element gets a unique int64 key: the float's bits mapped to an
    integer of the same order (negative floats have their magnitude bits
    flipped) in the high word, and ``2^32 - 1 - index`` in the low word.
    One ``torch.topk`` over the keys then has no ties to order, and no
    value leaves the device.  ``-0.0`` ranks with ``+0.0``.
    """
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} outside [0, {n}]")
    if x.dtype != torch.float32:
        raise TypeError(f"stable_topk takes float32, got {x.dtype}")
    bits = (x + 0.0).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.mul_(1 << 32).add_(
        (1 << 32) - 1 - torch.arange(n, dtype=torch.int64, device=x.device))
    _, idx = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def bm25_topk(doc_idx: torch.Tensor, impacts: torch.Tensor,
              qmask: torch.Tensor, n_docs: int, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exhaustive BM25 on the tensors' device.

    doc_idx  [Q, T, L] int32 padded with n_docs (the dropped slot)
    impacts  [Q, T, L] f32, zero where padded
    qmask    [Q, T]    f32 per-query term weights (0 = absent term)
    returns  (scores [Q, k] f32, ids [Q, k] int64)

    The accumulator is one flat ``[Q * (n_docs + 1)]`` buffer: row q's
    slot ``n_docs`` takes the padding and is never read.  It is filled by
    one ``index_add_`` per term, in term order.  Within one term the
    (query, doc) targets are distinct (padding aside), so no two updates of
    one call meet and every document's sum runs t = 0, 1, … exactly as the
    reference scatter does — the same bits, run after run, on either
    device.
    """
    q, t, _ = doc_idx.shape
    width = n_docs + 1
    acc = torch.zeros(q * width, dtype=torch.float32, device=impacts.device)
    rows = (torch.arange(q, device=impacts.device) * width).view(q, 1)
    contrib = impacts * qmask[:, :, None]
    for ti in range(t):
        acc.index_add_(0, (doc_idx[:, ti, :] + rows).reshape(-1),
                       contrib[:, ti, :].reshape(-1))
    return stable_topk(acc.view(q, width)[:, :n_docs], k)
