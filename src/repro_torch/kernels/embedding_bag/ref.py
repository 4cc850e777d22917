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
  row in the forward, and their gradient is dropped, whatever the weight,
  as the gradient of ``jnp.take``'s fill mode drops it.  Every other term
  is added, as the reference's take-plus-einsum gradient adds it: a term of
  weight 0 is ±0, which leaves a sum that starts at +0 as it was, unless
  grad_out[b] holds an inf or a NaN, where 0 · g is NaN;
- :func:`embedding_bag_backward_sorted_ref` — the same terms added in the
  CUDA kernel's order (``csrc/embedding_bag_backward.cu``): the items that
  add something (an id in range, a weight other than 0 or a non-finite
  grad_out row) sorted by row, stably; each row's run cut into pieces of at
  most PIECE items, each added in item order from +0; the pieces added in
  piece order.  A row named at most PIECE times equals the item-order
  version bit for bit.
"""

import torch

PIECE = 32   # items a piece of a row's run (the kernel's kPiece)


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
    keep = (ids >= -num_rows) & (ids < num_rows)
    rows = torch.where(ids < 0, ids + num_rows, ids)[keep]
    l = indices.shape[1]
    bag = torch.arange(ids.numel(), device=ids.device)[keep] // max(l, 1)
    grad = torch.zeros((num_rows, grad_out.shape[1]), dtype=acc_t,
                       device=grad_out.device)
    grad.index_add_(0, rows, w[keep, None] * grad_out.to(acc_t)[bag])
    return grad


def embedding_bag_backward_sorted_ref(grad_out: torch.Tensor,
                                      indices: torch.Tensor,
                                      weights: torch.Tensor,
                                      num_rows: int) -> torch.Tensor:
    """grad_out [B, D]; indices [B, L]; weights [B, L] float32 → the
    table's gradient [num_rows, D] in float32 (float64 for a float64
    grad_out), in the kernel's order: the terms sorted by row, stably,
    each row's pieces of at most PIECE items added in item order from +0,
    then the pieces added in piece order."""
    acc_t = torch.float64 if grad_out.dtype == torch.float64 \
        else torch.float32
    dev = grad_out.device
    g = grad_out.to(acc_t)
    ids = indices.long().reshape(-1)
    w = weights.to(acc_t).reshape(-1)
    bag = torch.arange(ids.numel(), device=dev) // max(indices.shape[1], 1)
    bad = ~torch.isfinite(g).all(1)
    keep = (ids >= -num_rows) & (ids < num_rows) & ((w != 0) | bad[bag])
    items = torch.nonzero(keep).reshape(-1)
    rows, order = torch.sort(torch.where(ids < 0, ids + num_rows,
                                         ids)[items], stable=True)
    items = items[order]
    grad = torch.zeros((num_rows, g.shape[1]), dtype=acc_t, device=dev)
    n = items.numel()
    if n == 0:
        return grad
    terms = w[items, None] * g[bag[items]]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = rows[1:] != rows[:-1]
    starts = torch.nonzero(head).reshape(-1)
    run = torch.cumsum(head, 0) - 1
    at = torch.arange(n, device=dev) - starts[run]   # the item's place in
    k = at % PIECE                                   # its run, its piece
    first = k == 0
    piece = torch.cumsum(first, 0) - 1
    partial = torch.zeros((int(first.sum()), g.shape[1]), dtype=acc_t,
                          device=dev)
    for i in range(PIECE):                   # the i-th item of each piece
        sel = k == i
        partial[piece[sel]] = partial[piece[sel]] + terms[sel]
    j, piece_run = (at // PIECE)[first], run[first]
    acc = partial[j == 0].clone()            # each run's first piece
    # then its later pieces, a place at a time: sorted stably by their
    # place in the run, each place's pieces (one a run) are one slice, so
    # a run of 10^6 items costs no host sync a place
    place, order = torch.sort(j, stable=True)
    ends = torch.bincount(place).cumsum(0).tolist()
    run_by, partial_by = piece_run[order], partial[order]
    for a, b in zip(ends[:-1], ends[1:]):
        r = run_by[a:b]
        acc[r] = acc[r] + partial_by[a:b]
    grad[rows[starts]] = acc
    return grad
