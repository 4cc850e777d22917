"""What model code needs to run on DTensors (``torch.distributed.tensor``)
on the port's meshes, beside the placements of ``dist/sharding.py``.

DTensor chooses each operator's layout alone, where the reference's
GSPMD plans the whole step; and some DTensor versions have no strategy
for an operator the models use, or turn no cut gradient back into a
pending sum.  So the models call these helpers, each a no-op on plain
tensors (one device, every CPU test of the reference's numerics):

* lookups as the reference's sharded ``jnp.take`` (:func:`take_rows`,
  :func:`gather_last`, and ``embedding_bag``'s through :func:`lookup_plan`
  and :func:`local_rows`): each rank looks up the ids in its own rows,
  and the ranks' parts are added inside the ``local_map``
  (:func:`local_summed`; DTensor would hand a pending sum's gradient to
  one rank of the sum only), a whole table's gradient summed over the
  ranks whose ids made it (:func:`whole_grad`);
* layouts pinned where DTensor's op-by-op choice fails or gathers the
  whole batch (:func:`keep_shards`, :func:`split_last`,
  :func:`logits_layout`, :func:`rows_like`), and gradients placed as
  their tensors (:func:`grad_like`);
* small work run whole or per row (:func:`replicated_local`,
  :func:`per_row`, :func:`segment_sum`);
* the one rule for plain tensors that model code makes
  (:func:`replicated_implicitly`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .sharding import _axis_size, data_axes, placements, prefix_entry


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def logits_layout(logits: torch.Tensor) -> torch.Tensor:
    """A DTensor of logits [B, ..., V] with its batch over the data axes
    (their longest prefix that divides B) and its vocabulary over
    ``model`` (where that divides V): the layout of the reference's
    vocab-sharded head.  DTensor's choice op by op would otherwise gather
    the batch to cut the vocabulary, and the loss's backward would hold
    the whole batch's logits on every device.  Any other tensor as it
    is."""
    if not is_dtensor(logits):
        return logits
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    vocab = "model" if "model" in names and \
        logits.shape[-1] % _axis_size(mesh, "model") == 0 else None
    spec = ((prefix_entry(mesh, logits.shape[0], data_axes(mesh)),)
            + (None,) * (logits.dim() - 2) + (vocab,))
    return logits.redistribute(mesh, placements(mesh, spec))


def local_part(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage it holds on this rank, so an
    in-place op on it changes the DTensor); any other tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def partial_sum(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's shard of ``like``, as a DTensor of
    ``like``'s mesh: a pending sum (``Partial``) on the mesh dimensions
    that shard ``like``, replicated on the others.  ``like`` must hold no
    pending sum itself."""
    places = [Partial() if p.is_shard() else Replicate()
              for p in like.placements]
    return DTensor.from_local(x, like.device_mesh, places, run_check=False)


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending sums (``Partial``) reduced: replicated on
    those mesh dimensions; any other tensor as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def replicated_implicitly():
    """The one rule for plain tensors that model code makes (constants,
    ``torch.ones``, ``arange``, the RoPE tables): inside this context a
    plain tensor that meets a DTensor counts as replicated on its mesh.
    Every step run on DTensors runs inside it."""
    return implicit_replication()


def rows_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x``, a DTensor whose rows go with ``ref``'s (an edge array and the
    edge ids), with its rows sharded as ``ref``'s and every other dimension
    whole: DTensor's gather may shard a narrow trailing dimension (the 3
    of a coordinate) unevenly, which a later flatten cannot take.  Any
    other tensor as it is."""
    if not is_dtensor(x):
        return x
    # pending sums reduced first, their gradient whole (some DTensor
    # versions turn no cut gradient back into a pending sum)
    return grad_like(settled(x)).redistribute(ref.device_mesh, [
        Shard(0) if p == Shard(0) else Replicate() for p in ref.placements])


def replicated_local(fn, n_out: int, *tensors):
    """``fn(*tensors)`` on whole copies: each DTensor argument replicated
    on its mesh (gathered where it was sharded), ``fn`` run on the local
    tensors, its ``n_out`` outputs replicated DTensors.  For small integer
    work that has no sharding strategy (``moe_dispatch``'s scatter on its
    [T, E] probabilities)."""
    mesh = next(t.device_mesh for t in tensors if is_dtensor(t))
    rep = [Replicate()] * mesh.ndim
    out = (rep,) * n_out if n_out > 1 else rep
    return local_map(fn, out_placements=out,
                     in_placements=tuple(rep for _ in tensors),
                     device_mesh=mesh, redistribute_inputs=True)(*tensors)


def local_range(x: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(first index, count) of dimension ``dim`` of ``x`` that this rank
    holds, from its mesh coordinate (``torch.chunk``'s cut on each mesh
    dimension that shards it, in mesh order): ``(0, size)`` for a plain
    tensor."""
    if not is_dtensor(x):
        return 0, x.shape[dim]
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    lo, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if getattr(p, "dim", None) == dim:
            if type(p) is not Shard:
                raise ValueError(f"dimension {dim} is placed {p}: not one "
                                 f"range a rank")
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            lo, size = lo + start, min(chunk, size - start)
    return lo, size


def row_cut(p) -> Optional[int]:
    """For a placement that cuts dimension 0: the blocks it cuts each of
    (1 for ``Shard(0)``; a ``_StridedShard``'s split factor, where a
    stacked [F, V, ...] cut on V was flattened to [F·V, ...]); else
    ``None``."""
    if getattr(p, "dim", None) != 0:
        return None
    return getattr(p, "split_factor", 1)


def lookup_plan(table: torch.Tensor, ids: torch.Tensor, lead: int):
    """How a lookup of rows of a DTensor ``table`` by ``ids`` (a DTensor
    on its mesh) runs, as the reference's sharded ``jnp.take``.  Where the
    table's
    rows are cut, every rank looks up the ids in its own rows (each block
    of ``block`` table rows holds ``lo .. lo + rows - 1`` here; one block
    unless a stacked [F, V, D] was flattened) and the output is a pending
    sum (``Partial``); where another of its dimensions d is cut, so is the
    output's dimension ``lead - 1 + d`` (the output holds ``lead`` leading
    dimensions of ids, then a row's); elsewhere the output follows the
    ids' first-dimension sharding, and there the table's gradient, made
    from each rank's own ids, is summed over those ranks (``grad_dims``,
    :func:`whole_grad`).  Returns ``(out placements, ids placements,
    block, lo, rows, grad_dims)``."""
    mesh = table.device_mesh
    coord = mesh.get_coordinate()
    out_pl, ids_pl, grad_dims = [], [], []
    block = table.shape[0]
    for tp in table.placements:
        if row_cut(tp):
            block //= row_cut(tp)
    lo, rows = 0, block
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if row_cut(tp):
            chunk = -(-rows // mesh.size(i))
            start = min(coord[i] * chunk, rows)
            lo, rows = lo + start, min(chunk, rows - start)
            out_pl.append(Partial())
            ids_pl.append(Replicate())
        elif isinstance(tp, Shard) and tp.dim >= 1:
            out_pl.append(Shard(lead - 1 + tp.dim))
            ids_pl.append(Replicate())
        elif tp.is_replicate():
            keep = ip == Shard(0)
            out_pl.append(Shard(0) if keep else Replicate())
            ids_pl.append(Shard(0) if keep else Replicate())
            if keep:
                grad_dims.append(i)
        else:
            raise ValueError(f"a table placed {table.placements} has no "
                             f"sharded lookup")
    return out_pl, ids_pl, block, lo, rows, tuple(grad_dims)


def local_rows(ids: torch.Tensor, block: int, lo: int, rows: int):
    """(local row, held): where each id's row sits in this rank's shard of
    the table (:func:`lookup_plan`), and whether it is there at all."""
    at = ids % block - lo
    held = (at >= 0) & (at < rows) & (ids >= 0)
    at = torch.div(ids, block, rounding_mode="floor") * rows + at
    return torch.where(held, at, 0), held


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; on a DTensor table (or DTensor ids), the lookup of
    :func:`lookup_plan` (each rank its own rows, zero elsewhere, summed
    where the rows are cut), its gradient on each rank's rows only."""
    if not is_dtensor(table) and not is_dtensor(ids):
        return table[ids]
    if not is_dtensor(table):     # a plain table made by model code
        table = DTensor.from_local(table, ids.device_mesh,
                                   [Replicate()] * ids.device_mesh.ndim,
                                   run_check=False)
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    out_pl, ids_pl, block, lo, rows, grad_dims = lookup_plan(table, ids,
                                                             ids.dim())

    def take(t, i):
        t = whole_grad(t, mesh, grad_dims)
        at, held = local_rows(i, block, lo, rows)
        return torch.where(held.reshape(held.shape + (1,) * (t.dim() - 1)),
                           t[at], 0)

    return local_summed(take, out_pl, (table.placements, ids_pl), mesh,
                        table, ids)


class _GradLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a pending sum's gradient is whole
        want = tuple(Replicate() if p.is_partial() else p
                     for p in ctx.placements)
        if is_dtensor(g) and tuple(g.placements) != want:
            g = g.redistribute(ctx.mesh, want)
        return g


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x``; on a DTensor, its gradient comes back placed as ``x`` is.  A
    reduction's backward broadcasts its gradient replicated (the whole
    tensor on every rank); a later product with a sharded tensor then
    cuts it, after the whole was made.  Placing the gradient where the
    reduction's input is placed cuts it while it is still a view."""
    return _GradLike.apply(x) if is_dtensor(x) else x


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``; on a DTensor
    ``x`` placed by :func:`logits_layout`, each rank gathers from its own
    range of the last dimension (zero for the others, a pending sum over
    those ranks) and its gradient is each rank's own columns: DTensor's
    gather would give back a whole-tensor gradient replicated on every
    rank."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    mesh = x.device_mesh
    last = x.dim() - 1
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    out_pl, idx_pl = [], []
    for p in x.placements:
        if p == Shard(last):
            out_pl.append(Partial())
            idx_pl.append(Replicate())
        elif p == Shard(0) or p.is_replicate():
            out_pl.append(p)
            idx_pl.append(p)
        else:
            raise ValueError(f"no local gather for {x.placements}")
    lo, n = local_range(x, last)

    def take(xl, il):
        at = il - lo
        held = (at >= 0) & (at < n)
        got = torch.gather(xl, -1, torch.where(held, at, 0)[..., None])
        return torch.where(held, got[..., 0], 0)

    return local_summed(take, out_pl, (x.placements, idx_pl), mesh, x, idx)


def keep_shards(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """A DTensor ``x`` with only its cuts of the dimensions ``dims`` kept,
    whole elsewhere (gathered, pending sums reduced); any other tensor as
    it is.  Attention keeps batch and KV heads: its products cut by
    anything else reach flattened, strided shards DTensor cannot
    multiply."""
    if not is_dtensor(x):
        return x
    want = [p if isinstance(p, Shard) and type(p) is Shard
            and p.dim in dims else Replicate() for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *shape)``; a DTensor whose last
    dimension is cut into more pieces than ``shape[0]`` divides into is
    gathered whole on those mesh dimensions first (Qwen2.5-14B's 8 KV
    heads on 16 ranks)."""
    if is_dtensor(x):
        last = Shard(x.dim() - 1)
        cuts = math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements) if p == last)
        if shape[0] % cuts:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == last else p for p in x.placements])
    return x.reshape(*x.shape[:-1], *shape)


def segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``x.new_zeros((n,) + x.shape[1:]).index_add(0, ids, x)`` (ids in
    [0, n)); on DTensors each rank adds its own rows of ``x`` (cut as the
    ids are) into a whole [n, ...] and the ranks' sums are added
    (:func:`local_summed`)."""
    if not is_dtensor(x):
        return x.new_zeros((n,) + x.shape[1:]).index_add(0, ids, x)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in ids.placements]
    out = [Partial() if p == Shard(0) else Replicate() for p in rows]
    return local_summed(
        lambda xl, il: xl.new_zeros((n,) + xl.shape[1:]).index_add(0, il, xl),
        out, (rows, rows), ids.device_mesh, x, ids)


class _SumAcross(torch.autograd.Function):
    """Each rank's local value summed over the mesh dimensions ``dims``
    (all-reduces), whole on every rank; the gradient of each rank's part
    is the whole gradient, as a sum's is."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        import torch.distributed._functional_collectives as funcol
        for d in dims:
            x = funcol.all_reduce(x, "sum", (mesh, d))
            if isinstance(x, funcol.AsyncCollectiveTensor):
                x = x.wait()
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def local_summed(fn, out_pl, in_pl, mesh, *args):
    """``local_map(fn)`` whose pending sums (``Partial`` in ``out_pl``) are
    added inside: each rank's local result all-reduced over those mesh
    dimensions, so the output is whole there and each rank's local
    backward gets the whole gradient (DTensor would hand a pending sum's
    gradient to one rank of the sum, the others zeros)."""
    dims = tuple(i for i, p in enumerate(out_pl) if p.is_partial())
    places = [Replicate() if p.is_partial() else p for p in out_pl]

    def run(*local):
        y = fn(*local)
        return _SumAcross.apply(y, mesh, dims) if dims else y

    return local_map(run, out_placements=places, in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


class _GradSumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _SumAcross.apply(g, ctx.mesh, ctx.dims), None, None


def whole_grad(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``x`` (a local tensor inside ``local_map`` whose DTensor is whole on
    the mesh dimensions ``dims``); its gradient summed over those ranks.
    Each rank's local backward gives only its own ids' part of a whole
    table's gradient; the whole gradient is their sum."""
    return _GradSumAcross.apply(x, mesh, tuple(dims)) if dims else x


def per_row(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a function of each row of ``x`` alone (a gather
    within the row); on a DTensor each rank runs it on its own rows (the
    rest of ``x`` whole), through ``local_map``: DTensor has no strategy
    for every such gather's backward in every version."""
    if not is_dtensor(x):
        return fn(x)
    x = keep_shards(x, (0,))
    return local_map(fn, out_placements=list(x.placements),
                     in_placements=(x.placements,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient made contiguous (a local tensor inside
    ``local_map`` whose gradient leaves as a DTensor's local part)."""
    return _ContiguousGrad.apply(x)


def rowwise(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)`` for a function of each row of ``x`` (its last
    dimension) and a whole weight ``w`` (a norm); on a DTensor each rank
    runs it on its own rows, the last dimension and ``w`` whole, and
    ``w``'s gradient is summed over the ranks that hold different rows.
    DTensor's own backward of the weight's broadcast flattens cut rows
    into a strided shard (QK-norm over cut heads)."""
    if not is_dtensor(x):
        return fn(x, w)
    x = keep_shards(x, tuple(range(x.dim() - 1)))
    mesh = x.device_mesh
    cut = tuple(i for i, p in enumerate(x.placements) if p.is_shard())
    whole = [Replicate()] * mesh.ndim
    return local_map(
        lambda xl, wl: fn(xl, whole_grad(wl, mesh, cut)),
        out_placements=list(x.placements),
        in_placements=(x.placements, whole if is_dtensor(w) else None),
        device_mesh=mesh, redistribute_inputs=True)(x, w)

