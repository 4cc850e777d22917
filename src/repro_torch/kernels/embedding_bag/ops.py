"""EmbeddingBag as the models call it, with its gradient, and the ragged →
padded adapter (``src/repro/kernels/embedding_bag/ops.py``)."""

import numpy as np
import torch

from repro_torch.dist.on_mesh import (is_dtensor, local_rows, local_summed,
                                      lookup_plan, whole_grad)

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
    indices = indices.to(torch.int32)
    weights = weights.to(torch.float32)
    if is_dtensor(table):
        return _sharded_bag(table, indices, weights)
    return kernel.embedding_bag(table, indices.contiguous(),
                                weights.contiguous())


def _sharded_bag(table, indices, weights):
    """The lookup on a DTensor table, as the reference's sharded
    ``jnp.take`` (``dist.sharding.lookup_plan``): where the table's rows
    are cut, every rank looks up the ids in its own rows (offset to them;
    the others weighted 0 at its row 0) and the output is a pending sum
    (added at once, :func:`~repro_torch.dist.on_mesh.local_summed`).
    ``local_map`` runs the kernel operator on the local tensors, so the
    table's gradient is the backward kernel's on each rank's rows only."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = table.device_mesh
    ids, w = (x if is_dtensor(x) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for x in (indices, weights))
    out_pl, ids_pl, block, lo, rows, grad_dims = lookup_plan(table, ids, 1)

    def lookup(t, i, wt):
        t = whole_grad(t, mesh, grad_dims)
        at, held = local_rows(i, block, lo, rows)
        return kernel.embedding_bag(t, at.to(torch.int32).contiguous(),
                                    torch.where(held, wt, 0.0).contiguous())

    return local_summed(lookup, out_pl, (table.placements, ids_pl, ids_pl),
                        mesh, table, ids, w)


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

