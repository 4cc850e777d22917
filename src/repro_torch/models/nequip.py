"""NequIP-style E(3)-equivariant GNN in PyTorch, Cartesian irreps — the JAX
package's ``repro.models.nequip`` (arXiv:2101.03164).

For l ≤ 2 the equivariant algebra has a closed Cartesian form:

  l=0 scalars        [N, C]
  l=1 vectors        [N, C, 3]
  l=2 sym-traceless  [N, C, 3, 3]

with the tensor-product paths written as dot, cross and symmetric-traceless
outer products.  Message passing is a scatter-add over the edge index into
zeros of ``n_nodes`` rows (the reference's ``jax.ops.segment_sum``):
``index_add``, whose float sums on CUDA are atomic, so two card calls agree
within rounding, not bit for bit.  Edge indices must lie in [0, n_nodes)
(``segment_sum`` drops the others; every generator here gives valid ones).

The model is an ``nn.Module`` whose parameters are named like the JAX
leaves (``species_embed``, ``layers.r_w1`` stacked on [n_layers], ...,
``head_w1``, ``head_w2``, ``feat_embed`` where the config has input
features), kept in the JAX ``[in, out]`` layout, so
:func:`repro_torch.convert.nequip_from_jax` copies them without a
transpose.  Parameters are made without gradients (serving); the trainer
turns them on.  The working dtype is the parameters' (float32, bfloat16,
or float64 for a widened copy); positions stay as given.

Energy is a sum of per-node scalars; forces are ``-∂E/∂positions`` by
autograd, so equivariance is testable end to end (E invariant, F rotates).
The molecule loss differentiates the force error again with respect to the
parameters (``create_graph=True``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.on_mesh import (grad_like, is_dtensor, rows_like,
                                      segment_sum, take_rows)

N_PATHS = 8          # tensor-product paths a layer (radial weights each)
LAYER_LEAVES = ("r_w1", "r_w2", "mix0", "mix1", "mix2", "gate1", "gate2",
                "self0")


@dataclasses.dataclass(frozen=True)
class NequipConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep order
    l_max: int = 2              # fixed Cartesian implementation for l <= 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    d_feat: int = 0             # raw input node-feature dim (0 = species only)
    n_classes: int = 0          # >0 → node classification head (graph shapes)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        c = self.d_hidden
        per_layer = (self.n_rbf * 2 * c * 8          # radial MLP (8 paths)
                     + 3 * c * c                      # per-l channel mixers
                     + 2 * c * c)                     # gates
        head = c * c + c * max(self.n_classes, 1)
        return self.n_layers * per_layer + self.n_species * c + head


def layer_shapes(cfg: NequipConfig) -> dict:
    """The shape of each layer leaf, without the stacked [n_layers] axis."""
    c = cfg.d_hidden
    shapes = {"r_w1": (cfg.n_rbf, 2 * c), "r_w2": (2 * c, N_PATHS * c)}
    shapes.update({name: (c, c) for name in LAYER_LEAVES[2:]})
    return shapes


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Nequip(nn.Module):
    def __init__(self, cfg: NequipConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, c = cfg.torch_dtype, cfg.d_hidden
        self.species_embed = _param((cfg.n_species, c), dt, device)
        self.layers = nn.ParameterDict({
            name: _param((cfg.n_layers,) + shape, dt, device)
            for name, shape in layer_shapes(cfg).items()})
        self.head_w1 = _param((c, c), dt, device)
        self.head_w2 = _param((c, max(cfg.n_classes, 1)), dt, device)
        if cfg.d_feat:
            self.feat_embed = _param((cfg.d_feat, c), dt, device)

    @property
    def device(self) -> torch.device:
        return self.species_embed.device


@torch.no_grad()
def init_params(cfg: NequipConfig, generator: torch.Generator,
                device=None) -> Nequip:
    """A model with random weights drawn from ``generator`` (which must
    live on ``device``), with the JAX package's distribution: every matrix
    N(0, 1/shape[0]) (a stacked layer leaf by its own first axis, not the
    layer axis), the species embedding N(0, 1), drawn in float32 and cast.
    The numbers differ from the JAX init's (another generator)."""
    model = Nequip(cfg, device)
    dev = model.device

    def normal(p: torch.Tensor, scale: float):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale)

    for layer in range(cfg.n_layers):
        for name in LAYER_LEAVES:
            p = model.layers[name][layer]
            normal(p, 1.0 / np.sqrt(max(p.shape[0], 1)))
    normal(model.species_embed, 1.0)
    for p in (model.head_w1, model.head_w2) + (
            (model.feat_embed,) if cfg.d_feat else ()):
        normal(p, 1.0 / np.sqrt(max(p.shape[0], 1)))
    return model


# --------------------------------------------------------------------- #
# the equivariant layers
# --------------------------------------------------------------------- #
def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis with smooth cutoff envelope (NequIP eq. 8)."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = (math.sqrt(2.0 / cutoff)
             * torch.sin(n * math.pi * r[..., None] / cutoff) / r[..., None])
    x = r / cutoff
    env = torch.where(x < 1.0, 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5,
                      0.0)
    return basis * env[..., None]


def _sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] onto its symmetric-traceless (l=2) part (on
    DTensors each rank its own rows, the 3 × 3 whole, through
    ``local_map``: DTensor has no strategy for the trace's backward in
    every version)."""
    if is_dtensor(m):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        places = [Replicate() if isinstance(p, Shard)
                  and p.dim >= m.dim() - 2 else p for p in m.placements]
        return local_map(_sym_traceless, out_placements=places,
                         in_placements=(places,), device_mesh=m.device_mesh,
                         redistribute_inputs=True)(m)
    sym = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return sym - tr * eye / 3.0


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cross(a, b, dim=-1)``; on DTensors (cut by rows, the
    3 whole) each rank's own rows, through ``local_map`` (DTensor has no
    strategy for the cross product in every version)."""
    if not is_dtensor(a):
        return torch.linalg.cross(a, b, dim=-1)
    from torch.distributed.tensor.experimental import local_map
    return local_map(lambda x, y: torch.linalg.cross(x, y, dim=-1),
                     out_placements=list(a.placements),
                     in_placements=(a.placements, a.placements),
                     device_mesh=a.device_mesh, redistribute_inputs=True)(
        a, b)


def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x``; on DTensors, its rows sharded as ``ids``' and every other
    dimension whole, its gradient placed so too (the channel products'
    backward would otherwise reach a flattened, strided shard)."""
    return grad_like(rows_like(x, ids))


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, ids, num_segments=n)`` for ids in [0, n);
    on DTensors, the sums' rows sharded as the ids' (:func:`rows_like`)."""
    return rows_like(segment_sum(x, ids, n), ids)


def _interact(cfg, lp, h0, h1, h2, senders, receivers, rbf, u, n_nodes):
    """One interaction block: TP messages over edges → segment-sum →
    update."""
    c = cfg.d_hidden
    w = rows_like(F.silu(rbf @ lp["r_w1"]) @ lp["r_w2"], senders)  # [E, 8c]
    w = w.reshape(-1, N_PATHS, c)                        # per-path radial wts

    s0, s1, s2 = (rows_like(take_rows(h, senders), senders)
                  for h in (h0, h1, h2))                 # [E, c(,3,(3))]
    y1 = u[:, None, :]                                   # [E, 1, 3]
    y2 = _sym_traceless(u[:, :, None] * u[:, None, :])   # [E, 3, 3]

    # tensor-product paths (Cartesian CG for l ≤ 2)
    m0 = (w[:, 0] * s0                                   # (0,0)->0
          + w[:, 1] * torch.einsum("eci,ei->ec", s1, u)  # (1,1)->0
          + w[:, 2] * torch.einsum("ecij,eij->ec", s2, y2))      # (2,2)->0
    m1 = (w[:, 3, :, None] * s0[:, :, None] * y1         # (0,1)->1
          + w[:, 4, :, None] * s1                        # (1,0)->1
          + w[:, 5, :, None] * _cross(s1, y1.expand_as(s1))  # (1,1)->1
          + w[:, 6, :, None] * torch.einsum("ecij,ej->eci", s2, u))  # (2,1)->1
    m2 = (w[:, 7, :, None, None]
          * _sym_traceless(s1[..., :, None] * y1[..., None, :]))    # (1,1)->2

    a0, a1, a2 = (_segment_sum(_rows(m, receivers), receivers, n_nodes)
                  for m in (m0, m1, m2))

    # node update: channel mixing per l + gated nonlinearity
    g1 = torch.sigmoid(a0 @ lp["gate1"])
    g2 = torch.sigmoid(a0 @ lp["gate2"])
    h0 = F.silu(h0 @ lp["self0"] + a0 @ lp["mix0"])
    h1 = h1 + g1[:, :, None] * torch.einsum("eci,cz->ezi", a1, lp["mix1"])
    h2 = h2 + g2[:, :, None, None] * torch.einsum("ecij,cz->ezij", a2,
                                                  lp["mix2"])
    return tuple(_rows(h, receivers) for h in (h0, h1, h2))


def apply(model: Nequip, positions: torch.Tensor, species: torch.Tensor,
          senders: torch.Tensor, receivers: torch.Tensor,
          node_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """positions [N, 3]; species [N] int; edges (senders → receivers) [E].

    Returns per-node scalars [N, C] after the interaction stack (the
    reference's ``scan`` over the stacked layers, as a loop)."""
    cfg = model.cfg
    n, c = positions.shape[0], cfg.d_hidden
    dt = model.species_embed.dtype
    senders, receivers = senders.long(), receivers.long()
    h0 = take_rows(model.species_embed, species.long() % cfg.n_species)
    if node_feats is not None and cfg.d_feat:
        h0 = h0 + (node_feats.to(dt) @ model.feat_embed)
    h1 = torch.zeros((n, c, 3), dtype=dt, device=positions.device)
    h2 = torch.zeros((n, c, 3, 3), dtype=dt, device=positions.device)

    # safe norm: zero-length edges (self loops / padding) contribute nothing
    # and their gradient path is cleanly severed (where on both sides),
    # otherwise d(rel/ε)/d(pos) injects huge non-equivariant force noise.
    rel = rows_like(take_rows(positions, receivers)
                    - take_rows(positions, senders), senders)
    r2 = torch.sum(rel * rel, dim=-1)
    ok = r2 > 1e-10
    r = torch.sqrt(torch.where(ok, r2, 1.0))
    u = torch.where(ok[:, None], rel / r[:, None], 0.0).to(dt)
    r = torch.where(ok, r, 2.0 * cfg.cutoff)   # outside cutoff → rbf = 0
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(dt)

    for i in range(cfg.n_layers):
        lp = {name: model.layers[name][i] for name in LAYER_LEAVES}
        h0, h1, h2 = _interact(cfg, lp, h0, h1, h2, senders, receivers, rbf,
                               u, n)
    return h0


def energy_fn(model: Nequip, positions, species, senders, receivers,
              graph_ids=None, n_graphs: int = 1) -> torch.Tensor:
    """Total energy per graph [n_graphs]: the sum of per-node scalar
    readouts (one graph when ``graph_ids`` is None)."""
    h0 = apply(model, positions, species, senders, receivers)
    e_node = (F.silu(h0 @ model.head_w1) @ model.head_w2)[:, 0]
    if graph_ids is None:
        return e_node.sum()[None]
    return _segment_sum(e_node, graph_ids.long(), n_graphs)


def energy_and_forces(model: Nequip, positions, species, senders, receivers,
                      graph_ids=None, n_graphs: int = 1,
                      create_graph: bool = False):
    """(energies [n_graphs], forces [N, 3] = -∂ΣE/∂positions).  The
    reference computes ``energy_fn`` twice (once under ``value_and_grad``);
    this takes the energies from the same forward, the same function.
    ``create_graph`` keeps the forces differentiable (a loss on them);
    otherwise both come back detached."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        energies = energy_fn(model, pos, species, senders, receivers,
                             graph_ids, n_graphs)
        (grad,) = torch.autograd.grad(energies.sum(), pos,
                                      create_graph=create_graph)
    if not create_graph:
        energies, grad = energies.detach(), grad.detach()
    return energies, -grad


def classify(model: Nequip, positions, species, senders, receivers,
             node_feats=None) -> torch.Tensor:
    """Node classification head [N, n_classes] (full_graph / minibatch
    shapes)."""
    h0 = apply(model, positions, species, senders, receivers, node_feats)
    return F.silu(h0 @ model.head_w1) @ model.head_w2


def loss_fn(model: Nequip, batch: Mapping) -> torch.Tensor:
    """Dispatch on task: molecule (energy + forces MSE) vs node
    classification (masked cross entropy in float32)."""
    if "energies" in batch:
        n_graphs = batch["energies"].shape[0]
        e, f = energy_and_forces(model, batch["positions"], batch["species"],
                                 batch["senders"], batch["receivers"],
                                 batch.get("graph_ids"), n_graphs,
                                 create_graph=True)
        le = torch.mean((e - batch["energies"]) ** 2)
        lf = torch.mean((f - batch["forces"]) ** 2)
        return le + lf
    logits = classify(model, batch["positions"], batch["species"],
                      batch["senders"], batch["receivers"],
                      batch.get("node_feats")).float()
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
