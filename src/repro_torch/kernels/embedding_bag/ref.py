"""Plain PyTorch versions of EmbeddingBag, with the JAX package's semantics
(``src/repro/kernels/embedding_bag``).

Row ids follow ``jnp.take``'s default rule, which torch indexing lacks: an
id in [-V, 0) wraps to id + V, and an id outside [-V, V) reads a row of
NaN ("fill" mode) — a NaN row stays NaN at weight 0, since 0 · NaN is NaN.

- :func:`take` — ``jnp.take(table, ids, axis=0)``;
- :func:`embedding_bag_ref` — the segment form (``ref.py``): rows scaled by
  their weights, summed per segment, ``"mean"`` divided by the segment's
  item count (at least 1);
- :func:`embedding_bag_padded_ref` — the padded form, with the Pallas
  body's arithmetic (``kernel.py:27-35``): the bag's items added in order,
  ``acc + w·row`` in float32 (float64 for a float64 table), cast to the
  table's dtype at the end.  In float32 this equals the reference's
  segment sum bit for bit, and its take-plus-einsum in value (at L = 1
  einsum returns w·row itself, -0.0 for a zero weight on a negative
  entry, where 0 + w·row is +0.0); the CUDA kernel does the same
  operations in the same order;
- :func:`embedding_bag_backward_ref` — the padded form's gradient with
  respect to the table: ``grad[indices[b, i]] += weights[b, i] ·
  grad_out[b]``, the products in float32 (float64 for a float64 table),
  added in item order.  Ids in [-V, 0) wrap; ids outside [-V, V) read a NaN
  row in the forward, and their gradient is dropped, as the gradient of
  ``jnp.take``'s fill mode drops it.  Items of weight 0 add nothing.
"""

import torch


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` [*ids.shape, D] under ``jnp.take``'s rule."""
    v = table.shape[0]
    ids = ids.long()
    ok = (ids >= -v) & (ids < v)
    rows = table[torch.where(ok, torch.where(ids < 0, ids + v, ids), 0)]
    nan = torch.tensor(float("nan"), dtype=table.dtype, device=table.device)
    return torch.where(ok.reshape(ok.shape + (1,) * (table.dim() - 1)),
                       rows, nan)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      segment_ids: torch.Tensor, n_bags: int,
                      weights=None, combiner: str = "sum") -> torch.Tensor:
    """table [V, D]; indices [N]; segment_ids [N] → [n_bags, D] in the
    table's dtype."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    rows = take(table, indices)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    out = torch.zeros((n_bags,) + rows.shape[1:], dtype=rows.dtype,
                      device=rows.device)
    out.index_add_(0, seg, rows)
    if combiner == "mean":
        cnt = torch.zeros(n_bags, dtype=table.dtype, device=table.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=table.dtype))
        out = out / cnt.clamp(min=1.0)[:, None]
    return out


def embedding_bag_padded_ref(table: torch.Tensor, indices: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """table [V, D]; indices [B, L]; weights [B, L] float32 → [B, D] in the
    table's dtype: Σ_i weights[b, i] · table[indices[b, i]], added in bag
    order."""
    acc_t = torch.float64 if table.dtype == torch.float64 else torch.float32
    b, l = indices.shape
    acc = torch.zeros((b, table.shape[1]), dtype=acc_t, device=table.device)
    w = weights.to(acc_t)
    for i in range(l):
        acc = acc + w[:, i, None] * take(table, indices[:, i]).to(acc_t)
    return acc.to(table.dtype)


def embedding_bag_backward_ref(grad_out: torch.Tensor, indices: torch.Tensor,
                               weights: torch.Tensor,
                               num_rows: int) -> torch.Tensor:
    """grad_out [B, D]; indices [B, L]; weights [B, L] float32 → the
    table's gradient [num_rows, D] in float32 (float64 for a float64
    grad_out), each row's contributions added in item order."""
    acc_t = torch.float64 if grad_out.dtype == torch.float64 \
        else torch.float32
    ids = indices.long().reshape(-1)
    w = weights.to(acc_t).reshape(-1)
    keep = (ids >= -num_rows) & (ids < num_rows) & (w != 0)
    rows = torch.where(ids < 0, ids + num_rows, ids)[keep]
    l = indices.shape[1]
    bag = torch.arange(ids.numel(), device=ids.device)[keep] // max(l, 1)
    grad = torch.zeros((num_rows, grad_out.shape[1]), dtype=acc_t,
                       device=grad_out.device)
    grad.index_add_(0, rows, w[keep, None] * grad_out.to(acc_t)[bag])
    return grad
