"""Sharding policies for the production meshes (``src/repro/dist/
sharding.py``), as DTensor placements.

The policy is divisibility-driven rather than name-driven, so it covers all
three families and every mesh of ``launch/mesh.py``: each axis group
("model" first, then the data axes under FSDP) is greedily assigned to the
largest not-yet-sharded dimension it divides evenly (the first of equal
ones).  That gives Megatron-style layouts on the LM's matrices and
row-sharded embedding tables on recsys, while odd-shaped leaves (norm
vectors, biases) stay replicated on that axis.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry a tensor
dimension: ``None``, a mesh axis name, or a tuple of names in mesh order
(``("pod", "data")``: the dimension cut by ``pod`` first, each piece by
``data``).  :func:`placements` turns it into one DTensor placement a mesh
dimension, ``Shard(d)`` on each axis of ``d``'s entry and ``Replicate()``
elsewhere; DTensor shards mesh dimensions in mesh order, which is jax's
order for such a tuple, so every rank holds the slice that the reference's
device at the same mesh coordinates holds.

Per-layer tensors.  The reference stacks each transformer layer leaf on a
leading ``[L]`` axis; the port keeps one tensor a layer and applies the
rule to that tensor's own shape.  The two agree wherever the reference
leaves ``L`` unsharded.  Where it shards ``L`` (under FSDP: a norm or bias
vector whose width no data group divides, at an ``L`` that one does) the
port's tensor stays replicated on those axes: :func:`layer_axis_leaves`
lists such leaves and the bytes a device holds beyond the reference's.

The policies return ``{name: placements}`` by parameter name (or by cache
and batch key); :func:`placement_spec` gives a placement tuple back as a
spec.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Axes = Tuple[str, ...]
Spec = Tuple[Union[None, str, Axes], ...]


def data_axes(mesh) -> Axes:
    """Every mesh axis except the tensor-parallel one ("model")."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _axes_size(mesh, axes: Axes) -> int:
    return math.prod(_axis_size(mesh, a) for a in axes) if axes else 1


def leaf_spec(mesh, shape: Sequence[int], groups: Sequence[Axes]) -> Spec:
    """Greedy assignment of axis groups to divisible dims (largest
    first): the reference's ``leaf_sharding`` as a spec."""
    shape = tuple(shape)
    spec = [None] * len(shape)
    for axes in groups:
        size = _axes_size(mesh, axes)
        if size <= 1:
            continue
        best = None
        for d in range(len(shape)):
            if spec[d] is None and shape[d] > 0 and shape[d] % size == 0:
                if best is None or shape[d] > shape[best]:
                    best = d
        if best is not None:
            spec[best] = tuple(axes) if len(axes) > 1 else axes[0]
    return tuple(spec)


def placements(mesh, spec: Spec) -> tuple:
    """One placement a mesh dimension for ``spec``: ``Shard(d)`` on the
    axes of dimension ``d``'s entry, ``Replicate()`` elsewhere.  A tuple
    entry must name its axes in mesh order (the order DTensor shards
    them, and jax's)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dimension {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def placement_spec(mesh, places: Sequence, ndim: int) -> Spec:
    """The spec of a placement tuple on ``mesh`` for a tensor of ``ndim``
    dimensions (the inverse of :func:`placements`; a ``Partial`` mesh
    dimension shows nowhere)."""
    from torch.distributed.tensor import Shard
    axes = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, places):
        if isinstance(p, Shard):
            axes[p.dim % ndim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def prefix_entry(mesh, size: int, preferred: Sequence[str]):
    """The spec entry of a dimension of ``size`` over the longest prefix
    of the axes ``preferred`` whose size divides it (the reference's
    ``_first_dim_sharding``): ``None``, an axis, or a tuple of axes."""
    axes = tuple(preferred)
    while axes and size % _axes_size(mesh, axes):
        axes = axes[:-1]
    return None if not axes else axes if len(axes) > 1 else axes[0]


def leaf_sharding(mesh, leaf, groups: Sequence[Axes]) -> tuple:
    """The placements of the greedy rule for ``leaf``'s shape."""
    return placements(mesh, leaf_spec(mesh, tuple(leaf.shape), groups))


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def _tree_sharding(mesh, params, groups) -> Dict[str, tuple]:
    return {name: leaf_sharding(mesh, leaf, groups)
            for name, leaf in _named(params).items()}


def lm_groups(mesh, fsdp: bool) -> list:
    """The LM's axis groups: ``model``, then the data axes under FSDP."""
    return [("model",)] + ([data_axes(mesh)] if fsdp else [])


# -- per-family policies ------------------------------------------------ #
def lm_param_sharding(mesh, params, fsdp: bool = False) -> Dict[str, tuple]:
    return _tree_sharding(mesh, params, lm_groups(mesh, fsdp))


def gnn_param_sharding(mesh, params) -> Dict[str, tuple]:
    return _tree_sharding(mesh, params, [("model",)])


def recsys_param_sharding(mesh, params) -> Dict[str, tuple]:
    # embedding tables are the big leaves -> row-sharded over "model"
    return _tree_sharding(mesh, params, [("model",)])


def recsys_batch_sharding(mesh) -> tuple:
    """A batch leaf's first dimension over every data axis."""
    return placements(mesh, (data_axes(mesh),))


def opt_state_sharding(param_sharding: Mapping[str, tuple]) -> Dict:
    """AdamW moments follow the params; the step counter is replicated."""
    from torch.distributed.tensor import Replicate
    ndim = len(next(iter(param_sharding.values())))
    return {"mu": dict(param_sharding), "nu": dict(param_sharding),
            "step": (Replicate(),) * ndim}


def lm_cache_sharding(mesh, batch: int, long_context: bool = False
                      ) -> Dict[str, tuple]:
    """KV cache [L, B, S, Hkv, Dh]: batch-sharded normally; for batch-1
    long-context decode (or a batch the data axes do not divide) the
    *sequence* dim is sharded instead (the 500k cell's sequence-sharded
    KV)."""
    dp = data_axes(mesh)
    dpe = dp if len(dp) > 1 else dp[0]
    if long_context or batch % _axes_size(mesh, dp) != 0:
        kv = placements(mesh, (None, None, dpe, None, None))
        length = placements(mesh, ())
    else:
        kv = placements(mesh, (None, dpe, None, None, None))
        length = placements(mesh, (dpe,))
    return {"k": kv, "v": kv, "length": length}


def layer_axis_leaves(mesh, model, fsdp: bool) -> Dict[str, dict]:
    """The transformer layer leaves whose stacked ``[L, ...]`` form the
    reference shards along ``L``: ``{leaf: {"reference": its spec,
    "port": the per-layer spec, "extra_bytes": what a device holds of the
    leaf's L tensors beyond the reference's share}}``.  Empty for any
    other model."""
    from repro_torch.models.transformer import Transformer, layer_shapes
    if not isinstance(model, Transformer):
        return {}
    cfg = model.cfg
    groups = lm_groups(mesh, fsdp)
    elt = torch.empty((), dtype=cfg.torch_dtype).element_size()
    out = {}
    for leaf, shape in layer_shapes(cfg).items():
        ref = leaf_spec(mesh, (cfg.n_layers,) + shape, groups)
        if ref[0] is None:
            continue
        port = leaf_spec(mesh, shape, groups)
        out[leaf] = {"reference": ref, "port": port,
                     "extra_bytes": elt * (
                         cfg.n_layers * math.prod(shard_shape(mesh, shape, port))
                         - math.prod(shard_shape(
                             mesh, (cfg.n_layers,) + shape, ref)))}
    return out


def shard_shape(mesh, shape: Sequence[int], spec: Spec) -> Tuple[int, ...]:
    """Each device's shard of an evenly divided ``shape`` under ``spec``."""
    out = []
    for size, entry in zip(shape, spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            size //= _axes_size(mesh, axes)
        out.append(size)
    return tuple(out)


def distribute(tree: Mapping[str, torch.Tensor], mesh,
               shardings: Mapping[str, tuple],
               src_data_rank: Optional[int] = 0) -> Dict[str, torch.Tensor]:
    """Every tensor of ``tree`` as a DTensor on ``mesh`` with its
    placements in ``shardings`` (by the same key)."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, shardings[k],
                                 src_data_rank=src_data_rank)
            for k, v in tree.items()}


_RULES = []


def register_operator_rules() -> None:
    """DTensor sharding rules of the port's kernel operators (once):
    ``gqa_decode`` over B and over the KV heads (q's dim 1, K's and V's
    dim 2, ``length`` whole), else replicated; ``interval_join`` and
    ``bm25_blockmax`` replicated.  ``embedding_bag`` needs its ids offset
    on a row-sharded table, which no placement rule can say:
    :func:`repro_torch.kernels.embedding_bag.ops.embedding_bag_padded`
    runs it through ``local_map`` instead, its gradient with it."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    # each import registers its operator with the dispatcher
    from repro_torch.kernels.bm25_blockmax import kernel as bm25
    from repro_torch.kernels.gqa_decode import kernel as gqa
    from repro_torch.kernels.interval_join import kernel as join

    r = Replicate()

    @register_sharding(torch.ops.repro_torch.gqa_decode.default)
    def _gqa(q, k, v, length):
        return [([r], [r, r, r, r]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0), Shard(0)]),
                ([Shard(1)], [Shard(1), Shard(2), Shard(2), r])]

    def replicated(op):
        ins = [r if isinstance(a.type, torch.TensorType) else None
               for a in op._schema.arguments]
        outs = [r] * len(op._schema.returns)
        register_sharding(op)(lambda *args, **kwargs: [(outs, ins)])

    for op in (torch.ops.repro_torch.interval_join.default,
               torch.ops.repro_torch.blockmax_scores.default):
        replicated(op)
    _RULES.extend([gqa, bm25, join])


def distribute_module(model: torch.nn.Module, mesh,
                      shardings: Mapping[str, tuple],
                      src_data_rank: Optional[int] = 0) -> torch.nn.Module:
    """Every parameter of ``model`` (by name) replaced, in place, by a
    DTensor parameter on ``mesh`` with its placements in ``shardings``;
    the kernel operators' rules registered.  Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor
    register_operator_rules()
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, shardings[name],
                                  src_data_rank=src_data_rank),
                requires_grad=p.requires_grad))
    return model
