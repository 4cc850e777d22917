"""NequIP and the four GNN shape cells of the JAX package
(``src/repro/configs/gnn_family.py``).

  full_graph_sm  2,708 nodes / 10,556 edges / d_feat 1,433  (full-batch)
  minibatch_lg   232,965-node graph, sampled: 1,024 seeds, fanout 15-10
  ogb_products   2,449,029 nodes / 61,859,140 edges / d_feat 100
  molecule       128 graphs × 30 nodes / 64 edges (energy + forces)

NequIP is an interatomic potential; the generic graph cells are mapped onto
it as spatial graphs: every node carries a position (the geometry the
equivariant tensor products consume) plus optional high-dimensional
features; the classification shapes use a node-classification head.

:func:`cfg_for_cell` gives a cell's config (its head and input width),
:func:`gnn_smoke_batch` the reference's smoke batch, :func:`loss_fn` its
loss and :func:`serve` its ``serve_fn``
(:func:`repro_torch.models.nequip.classify`); :data:`GNN_SPECS` holds the
``ArchSpec`` (:func:`make_gnn_spec`) with the four cells
(:func:`gnn_cells`), and :func:`get_config` looks a configuration up by
name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.data import synth
from repro_torch.models import nequip as NQ

from .base import ArchSpec, Cell, f32, i32, sds


def _pad512(n: int) -> int:
    """Graph arrays are padded to a 512-multiple in the reference's cells
    (padding = masked nodes and edges)."""
    return -(-n // 512) * 512


# sampled-subgraph padded sizes for minibatch_lg (1024 seeds, fanout 15-10)
_MB_NODES = 1024 + 1024 * 15 + 1024 * 150          # padded upper bound
_MB_EDGES = 1024 * 15 + 1024 * 15 * 10

SHAPES = {
    "full_graph_sm": dict(n=_pad512(2708), e=_pad512(10_556), d_feat=1433,
                          n_classes=7, kind="train"),
    "minibatch_lg": dict(n=_pad512(_MB_NODES), e=_pad512(_MB_EDGES),
                         d_feat=602, n_classes=41, kind="train"),
    "ogb_products": dict(n=_pad512(2_449_029), e=_pad512(61_859_140),
                         d_feat=100, n_classes=47, kind="train"),
    "molecule": dict(n=_pad512(128 * 30), e=_pad512(128 * 64), d_feat=0,
                     n_classes=0, kind="train", n_graphs=128),
}

def gnn_cells(cfg: NQ.NequipConfig) -> Dict[str, Cell]:
    cells = {}
    for name, sh in SHAPES.items():
        specs = {
            "positions": sds((sh["n"], 3), f32),
            "species": sds((sh["n"],), i32),
            "senders": sds((sh["e"],), i32),
            "receivers": sds((sh["e"],), i32),
        }
        if sh["n_classes"]:
            specs["node_feats"] = sds((sh["n"], sh["d_feat"]), f32)
            specs["labels"] = sds((sh["n"],), i32)
            specs["label_mask"] = sds((sh["n"],), f32)
        else:
            specs["graph_ids"] = sds((sh["n"],), i32)
            specs["energies"] = sds((sh["n_graphs"],), f32)
            specs["forces"] = sds((sh["n"], 3), f32)
        cells[name] = Cell(name, "train", specs,
                           note=f"{sh['n']} nodes / {sh['e']} edges")
    return cells


NEQUIP = NQ.NequipConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                         n_rbf=8, cutoff=5.0)

NEQUIP_SMOKE = NQ.NequipConfig(name="nequip-smoke", n_layers=2, d_hidden=8,
                               n_rbf=4, cutoff=5.0, d_feat=16, n_classes=5)

# name → (config, smoke config)
ARCHS = {"nequip": (NEQUIP, NEQUIP_SMOKE)}


def get_config(name: str, smoke: bool = False) -> NQ.NequipConfig:
    """The configuration ``name`` (one of :data:`ARCHS`), or its smoke
    config with ``smoke=True``."""
    if name not in ARCHS:
        raise KeyError(f"unknown GNN config {name!r}; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name][1 if smoke else 0]


def cfg_for_cell(cfg: NQ.NequipConfig, shape_name: str) -> NQ.NequipConfig:
    """Shape cells differ in head (classes) and input feature width."""
    sh = SHAPES[shape_name]
    return dataclasses.replace(cfg, d_feat=sh["d_feat"],
                               n_classes=sh["n_classes"])


def gnn_smoke_batch(cfg: NQ.NequipConfig, kind: str = "train",
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The reference's ``gnn_smoke_batch`` (numpy): a random graph of 64
    nodes and 256 edges with the config's features and classes, or, for a
    config without classes, 4 molecules of 8 nodes and 16 edges."""
    if cfg.n_classes:
        return synth.random_graph(seed, 64, 256, d_feat=cfg.d_feat,
                                  n_classes=cfg.n_classes)
    return synth.molecule_batch(seed, batch=4, n_nodes=8, n_edges=16)


def _on_device(model: NQ.Nequip, batch: Mapping) -> dict:
    """``batch`` with its arrays as tensors on the model's device (scalars
    such as ``n_graphs`` stay as they are)."""
    dev = model.device
    return {k: v if np.isscalar(v) else torch.as_tensor(v, device=dev)
            for k, v in batch.items()}


def loss_fn(model: NQ.Nequip, batch: Mapping) -> torch.Tensor:
    """The training loss on ``batch`` (numpy arrays are copied to the
    model's device): energy and force MSE for molecules, masked cross
    entropy for node classification."""
    return NQ.loss_fn(model, _on_device(model, batch))


def serve(model: NQ.Nequip, batch: Mapping) -> torch.Tensor:
    """The reference's ``serve_fn``: node logits [N, n_classes] of
    ``classify`` on ``batch`` (numpy arrays are copied to the model's
    device)."""
    b = _on_device(model, batch)
    return NQ.classify(model, b["positions"], b["species"], b["senders"],
                       b["receivers"], b.get("node_feats"))


def make_gnn_spec() -> ArchSpec:
    return ArchSpec(
        name="nequip", family="gnn", config=NEQUIP, smoke_config=NEQUIP_SMOKE,
        init_fn=NQ.init_params, build_fn=NQ.Nequip,
        loss_fn=lambda m, c, b: loss_fn(m, b),
        serve_fn=lambda m, c, b: serve(m, b),
        cells=gnn_cells, smoke_batch=gnn_smoke_batch,
    )


GNN_SPECS = {"nequip": make_gnn_spec()}
