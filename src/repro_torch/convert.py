"""Carry state across from the JAX package.

- Committed index state: segment records → a DynamicIndex.  A record is
  the plain-dict durable form of one committed segment
  (``Segment.to_record()``: ints, bytes, str and lists, vByte gap-coded
  postings).  Both packages write and read the same form, so an index
  built elsewhere serves here from the same committed state, at the same
  addresses.
- Transformer weights: the JAX package's parameters as numpy arrays → a
  :class:`~repro_torch.models.transformer.Transformer`.
- Recsys weights: the same for DLRM, xDeepFM, two-tower and SASRec →
  the modules of :mod:`repro_torch.models.recsys`.
- NequIP weights: the same → :class:`repro_torch.models.nequip.Nequip`.
- And back: :func:`model_tree` lays a model's tensors out as the JAX
  package's parameter pytree (the transformer's layers stacked), which is
  how train-state checkpoints are written.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.featurizer import Featurizer
from repro_torch.dist.checkpoint import Stacked
from repro_torch.core.index import DynamicIndex, Segment
from repro_torch.core.tokenizer import Tokenizer
from repro_torch.models import nequip, recsys
from repro_torch.models.transformer import (Transformer, TransformerConfig,
                                            layer_shapes)


def index_from_records(records: Iterable[dict],
                       tokenizer: Optional[Tokenizer] = None,
                       featurizer: Optional[Featurizer] = None
                       ) -> DynamicIndex:
    """A new in-memory index holding the committed segments ``records``
    (``"ready"`` records, any order), as if each had been committed in
    seqnum order: new transactions get later seqnums and addresses."""
    segments = sorted((Segment.from_record(r) for r in records),
                      key=lambda s: s.seqnum)
    seqs = [s.seqnum for s in segments]
    if len(set(seqs)) != len(seqs):
        raise ValueError("two records share a seqnum")
    index = DynamicIndex(tokenizer, featurizer)
    for seg in segments:
        index._log.append(seg.to_record(), sync=False)
        index._log.append({"t": "commit", "seq": seg.seqnum}, sync=False)
    index._segments = tuple(segments)
    index._version = 1
    if segments:
        index._next_seq = segments[-1].seqnum + 1
        index._next_addr = max(s.base + s.length for s in segments)
    return index


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit.  JAX hands bfloat16 over as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses: their
    bits are reinterpreted through int16 instead (no ``ml_dtypes``
    import)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # JAX hands over read-only buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, src: np.ndarray, name: str):
    t = _tensor(src)
    if t.dtype != dst.dtype or tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: got {t.dtype} {tuple(t.shape)}, the "
                         f"config needs {dst.dtype} {tuple(dst.shape)}")
    dst.copy_(t)


@torch.no_grad()
def transformer_from_jax(params: Mapping, cfg: TransformerConfig,
                         device=None) -> Transformer:
    """The JAX package's transformer parameters → the port's model.

    ``params`` is the nested dict that ``jax.tree.map(np.asarray, params)``
    gives: ``embed`` [V, D], ``layers`` (each leaf stacked along a leading
    [L] axis), ``final_norm`` [D], ``lm_head`` [D, V].  Both packages keep
    weights as ``[in, out]``, so each leaf is copied, not transposed, one
    layer at a time, bit for bit; every leaf must already have the
    config's dtype.
    """
    model = Transformer(cfg, device)
    want = layer_shapes(cfg)
    layers = params["layers"]
    if set(layers) != set(want):
        raise ValueError(f"layer leaves {sorted(layers)} do not match the "
                         f"config's {sorted(want)}")
    for name, shape in want.items():
        leaf = layers[name]
        if leaf.shape != (cfg.n_layers,) + shape:
            raise ValueError(f"layers.{name} has shape {leaf.shape}, the "
                             f"config needs {(cfg.n_layers,) + shape}")
        for i, layer in enumerate(model.layers):
            _copy(getattr(layer, name), leaf[i], f"layers.{name}[{i}]")
    for name in ("embed", "final_norm", "lm_head"):
        _copy(getattr(model, name), params[name], name)
    return model


def _flatten(tree, prefix: str = ""):
    """(dotted name, leaf) of a nested dict/list pytree: ``bot.0.w``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


@torch.no_grad()
def recsys_from_jax(params: Mapping, cfg, device=None) -> recsys._Recsys:
    """The JAX package's recsys parameters → the port's model of ``cfg``.

    ``params`` is the pytree that ``jax.tree.map(np.asarray, params)``
    gives for the config's architecture: DLRM ``tables``, ``bot``/``top``
    as lists of ``{w, b}``; xDeepFM ``tables``, ``cin`` (a list),
    ``cin_out``, ``mlp``, ``linear``; two-tower ``user_table``,
    ``item_table``, ``user_tower``, ``item_tower``; SASRec ``item_embed``,
    ``pos_embed`` and ``blocks`` (each leaf stacked on [n_blocks]).  Both
    packages keep weights as ``[in, out]``, so each leaf is copied bit for
    bit, not transposed; the leaves must be exactly the model's, each of
    the config's shape and dtype.
    """
    return _copy_leaves(recsys.make_model(cfg, device), params)


@torch.no_grad()
def nequip_from_jax(params: Mapping, cfg: nequip.NequipConfig,
                    device=None) -> nequip.Nequip:
    """The JAX package's NequIP parameters → the port's model of ``cfg``.

    ``params`` is the pytree that ``jax.tree.map(np.asarray, params)``
    gives: ``species_embed``, ``layers`` (each leaf stacked on
    [n_layers]), ``head_w1``, ``head_w2`` and, with input features,
    ``feat_embed``.  Each leaf is copied bit for bit, stacked as it is;
    the leaves must be exactly the model's, each of the config's shape and
    dtype."""
    return _copy_leaves(nequip.Nequip(cfg, device), params)


def _copy_leaves(model: torch.nn.Module, params: Mapping):
    """Copy the pytree ``params`` into ``model``'s parameters of the same
    dotted names, bit for bit."""
    want = dict(model.named_parameters())
    got = dict(_flatten(params))
    if set(got) != set(want):
        raise ValueError(f"leaves {sorted(got)} do not match the config's "
                         f"{sorted(want)}")
    for name, p in want.items():
        _copy(p, got[name], name)
    return model


def model_tree(model: torch.nn.Module,
               named: Optional[Mapping[str, torch.Tensor]] = None):
    """``named`` (default: the model's parameters; or any dict keyed by
    parameter name, like the optimizer's moments) as the JAX package's
    pytree of the model: dicts by leaf name, lists where the reference
    has lists (``bot.0.w`` → ``{"bot": [{"w": ...}]}``), and for a
    :class:`Transformer` the ``layers`` leaves as :class:`Stacked` lists
    of the per-layer tensors, the inverse of :func:`transformer_from_jax`.
    The tensors are the ones given, not copies."""
    if named is None:
        named = dict(model.named_parameters())
    if isinstance(model, Transformer):
        n = model.cfg.n_layers
        return {"embed": named["embed"], "final_norm": named["final_norm"],
                "layers": {leaf: Stacked(named[f"layers.{i}.{leaf}"]
                                         for i in range(n))
                           for leaf in layer_shapes(model.cfg)},
                "lm_head": named["lm_head"]}
    tree: dict = {}
    for name, t in named.items():
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
