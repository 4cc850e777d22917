"""Recsys architectures in PyTorch: DLRM-RM2, xDeepFM (CIN), two-tower
retrieval and SASRec, with their training losses — the JAX package's
``repro.models.recsys``.

Each model is an ``nn.Module`` whose parameters are named like the JAX
leaves (``tables``, ``bot.0.w``, ``cin.1``, ``blocks.wq`` stacked on
[n_blocks], ...), kept in the JAX ``[in, out]`` layout, so
:func:`repro_torch.convert.recsys_from_jax` copies them without a
transpose.  Parameters are made without gradients (serving); the trainer
turns them on for the model it trains, and each lookup's table gradient
is the ``embedding_bag`` backward kernel's.

Every table lookup goes through the ``embedding_bag`` kernel's op
(:func:`repro_torch.kernels.embedding_bag.embedding_bag_padded`), at the
points where the reference takes rows, so the launches per call are fixed:
DLRM 1, xDeepFM 2, two-tower user embedding 2 (3 with candidates or in
its loss), SASRec encoding 1 (2 with candidates, 3 in its loss); a
training step launches the backward kernel as many times.  Ids follow
``jnp.take``: [-V, 0) wraps, outside [-V, V) gives a NaN row.

Kept from the reference as it is:
- DLRM's top MLP takes ``embed_dim + n_pairs`` inputs; ``cfg.top_mlp[0]``
  is never read;
- SASRec scores candidates against ``h[b, len - 1]``, but its batches are
  padded on the left, so for 2·len − 1 < S that row is one that
  ``sasrec_encode`` zeroed, and the score row is all zero (ROADMAP.md §3,
  fault (i));
- the losses' formulas, SASRec's ``log1p(exp(·))`` (not the stable form)
  included.  Two-tower's streamed loss (``loss_chunk``) differs in its
  backward: where the reference differentiates through its scan, the port
  recomputes each [B, chunk] block of the softmax from the saved log
  normalizer (:class:`_StreamedLogZ`), so memory stays O(B · chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.dist.on_mesh import (is_dtensor, local_range, local_summed,
                                      per_row, settled, whole_grad)
from repro_torch.kernels.embedding_bag import ops as bag_ops

TABLE_LEAVES = ("tables", "linear", "user_table", "item_table", "item_embed",
                "pos_embed")
TABLE_STD = 0.01
INIT_CHUNK = 1 << 24        # elements drawn at a time by init_params


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _wide(x: torch.Tensor) -> torch.Tensor:
    """Where the reference widens to float32: float64 stays float64 (a
    model made float64 with ``.double()`` is the tests' oracle)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_table: int = 1_000_000
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_table: int = 100_000
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    n_users: int = 2_000_000
    n_items: int = 1_000_000
    n_user_feats: int = 8        # multi-hot user history features per example
    loss_chunk: int = 0          # streamed in-batch softmax chunk (training)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_items: int = 1_000_000
    dropout: float = 0.0         # deterministic runs
    dtype: str = "float32"
    scan_unroll: int = 1         # the reference's scan; blocks run in a loop

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)


# --------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------- #
def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """One MLP layer, ``x @ w + b``; w is [in, out]."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


def _mlp(dims: Sequence[int], dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device)
                         for i in range(len(dims) - 1))


def _mlp_apply(layers, x: torch.Tensor, final_act: bool = False
               ) -> torch.Tensor:
    for i, layer in enumerate(layers):
        # on DTensors a product's pending sum is reduced before the bias
        # is added (a cut bias cannot become a pending sum everywhere)
        x = settled(torch.matmul(x, layer.w)) + layer.b
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


class _Recsys(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class DLRM(_Recsys):
    def __init__(self, cfg: DLRMConfig, device=None):
        super().__init__(cfg)
        dt = cfg.torch_dtype
        n_feat = cfg.n_sparse + 1
        top_in = cfg.embed_dim + n_feat * (n_feat - 1) // 2
        self.tables = _param((cfg.n_sparse, cfg.vocab_per_table,
                              cfg.embed_dim), dt, device)
        self.bot = _mlp(cfg.bot_mlp, dt, device)
        self.top = _mlp((top_in,) + tuple(cfg.top_mlp[1:]), dt, device)


class XDeepFM(_Recsys):
    def __init__(self, cfg: XDeepFMConfig, device=None):
        super().__init__(cfg)
        dt = cfg.torch_dtype
        m = cfg.n_sparse
        shapes, h_prev = [], m
        for h in cfg.cin_layers:
            shapes.append((h, h_prev * m))
            h_prev = h
        self.tables = _param((m, cfg.vocab_per_table, cfg.embed_dim), dt,
                             device)
        self.cin = nn.ParameterList(_param(s, dt, device) for s in shapes)
        self.cin_out = _param((sum(cfg.cin_layers), 1), dt, device)
        self.mlp = _mlp((m * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), dt,
                        device)
        self.linear = _param((m, cfg.vocab_per_table, 1), dt, device)


class TwoTower(_Recsys):
    def __init__(self, cfg: TwoTowerConfig, device=None):
        super().__init__(cfg)
        dt = cfg.torch_dtype
        d = cfg.embed_dim
        self.user_table = _param((cfg.n_users, d), dt, device)
        self.item_table = _param((cfg.n_items, d), dt, device)
        self.user_tower = _mlp((d,) + tuple(cfg.tower_mlp), dt, device)
        self.item_tower = _mlp((d,) + tuple(cfg.tower_mlp), dt, device)


class SASRecBlocks(nn.Module):
    """The blocks' weights, each stacked along a leading [n_blocks] axis
    as the reference stacks them for its scan."""

    def __init__(self, cfg: SASRecConfig, device=None):
        super().__init__()
        n, d, dt = cfg.n_blocks, cfg.embed_dim, cfg.torch_dtype
        for name in ("wq", "wk", "wv", "wo", "ff1", "ff2"):
            self.register_parameter(name, _param((n, d, d), dt, device))
        for name in ("ln1", "ln2"):
            self.register_parameter(name, _param((n, d), dt, device))


class SASRec(_Recsys):
    def __init__(self, cfg: SASRecConfig, device=None):
        super().__init__(cfg)
        dt = cfg.torch_dtype
        self.item_embed = _param((cfg.n_items, cfg.embed_dim), dt, device)
        self.pos_embed = _param((cfg.seq_len, cfg.embed_dim), dt, device)
        self.blocks = SASRecBlocks(cfg, device)


MODELS = {DLRMConfig: DLRM, XDeepFMConfig: XDeepFM,
          TwoTowerConfig: TwoTower, SASRecConfig: SASRec}


def make_model(cfg, device=None) -> _Recsys:
    """The model of ``cfg``'s architecture with uninitialised parameters
    on ``device`` (``None`` means the card, which raises without one): see
    :func:`init_params` and :func:`repro_torch.convert.recsys_from_jax`.
    """
    if type(cfg) not in MODELS:
        raise TypeError(f"not a recsys config: {type(cfg).__name__}")
    return MODELS[type(cfg)](cfg, resolve_device(device))


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def _init_std(name: str, p: torch.Tensor):
    """The reference's scale for leaf ``name``: tables 0.01; dense weights
    1/√shape[0] of the unstacked leaf (for CIN's [h, h_prev·m] that is h);
    None for biases (0) and LayerNorm gains (1)."""
    top = name.split(".")[0]
    if top in TABLE_LEAVES:
        return TABLE_STD
    if name.endswith(".b") or name in ("blocks.ln1", "blocks.ln2"):
        return None
    return 1.0 / np.sqrt(max(p.shape[1] if top == "blocks" else p.shape[0],
                             1))


@torch.no_grad()
def init_params(cfg, generator: torch.Generator, device=None) -> _Recsys:
    """A model with random weights drawn from ``generator`` (which must
    live on ``device``), with the JAX package's distribution: tables
    N(0, 0.01²), dense layers N(0, 1/shape[0]), biases 0, LayerNorm gains
    1.  Draws in float32, at most ``INIT_CHUNK`` elements at a time, so no
    second copy of a 6.66 GB table is held.  The numbers differ from the
    JAX init's (another generator)."""
    model = make_model(cfg, device)
    dev = model.device
    for name, p in model.named_parameters():
        std = _init_std(name, p)
        if std is None:
            p.fill_(1.0 if name.startswith("blocks.ln") else 0.0)
            continue
        for part in p.view(-1).split(INIT_CHUNK):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32) * std)
    return model


# --------------------------------------------------------------------- #
# lookups: every one is an embedding_bag launch
# --------------------------------------------------------------------- #
def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` [*ids.shape, D] as bags of one of
    weight 1 (exact: 0 + 1·x is x): one launch."""
    flat = ids.reshape(-1, 1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=table.device)
    rows = bag_ops.embedding_bag_padded(table, flat, ones)
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))


def _field_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, D]; ids [B, F] → [B, F, D]: the reference's take per
    field, as one launch of bags of one over the tables viewed as
    [F·V, D] with field f's ids offset by f·V.  The wrap and NaN rule is
    applied per field first, so a bad id never reads another field's row:
    it becomes F·V, which is out of range of the whole view."""
    if is_dtensor(tables):
        return _field_lookup_sharded(tables, ids)
    f, v, d = tables.shape
    if f * v > np.iinfo(np.int32).max:
        raise ValueError(f"{f} tables of {v} rows exceed int32 row ids")
    ids = ids.long()
    ok = (ids >= -v) & (ids < v)
    offset = torch.arange(f, device=ids.device) * v
    flat = torch.where(ids < 0, ids + v, ids) + offset
    flat = torch.where(ok, flat, f * v).to(torch.int32)
    return _take(tables.view(f * v, d), flat)


def _field_lookup_sharded(tables: torch.Tensor, ids: torch.Tensor
                          ) -> torch.Tensor:
    """:func:`_field_lookup` on DTensor tables whose rows (dim 1) may be
    cut: each rank looks up the ids in its own rows of every field (one
    launch over its [F·rows, D] view; ids elsewhere weighted 0) and the
    ranks' bags are added (``local_summed``); where the tables are whole
    the output follows the ids' batch cut and the tables' gradient is
    summed over those ranks.  An id out of range adds 0 here, where the
    plain lookup reads the out-of-range row."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = tables.device_mesh
    f, v, d = tables.shape
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    out_pl, ids_pl, grad_dims = [], [], []
    for i, (tp, ip) in enumerate(zip(tables.placements, ids.placements)):
        if tp == Shard(1):
            out_pl.append(Partial())
            ids_pl.append(Replicate())
        elif tp.is_replicate():
            keep = ip == Shard(0)
            out_pl.append(Shard(0) if keep else Replicate())
            ids_pl.append(Shard(0) if keep else Replicate())
            if keep:
                grad_dims.append(i)
        else:
            raise ValueError(f"tables placed {tables.placements} have no "
                             f"sharded lookup")
    lo, rows = local_range(tables, 1)

    def look(t, i):
        t = whole_grad(t, mesh, grad_dims)
        i = i.long()
        ok = (i >= -v) & (i < v)
        at = torch.where(i < 0, i + v, i) - lo
        held = ok & (at >= 0) & (at < rows)
        flat = torch.where(held, at + torch.arange(f, device=i.device) * rows,
                           0).reshape(-1, 1)
        got = bag_ops.embedding_bag_padded(
            t.reshape(f * rows, d), flat, held.reshape(-1, 1).float())
        return got.reshape(tuple(i.shape) + (d,))

    return local_summed(look, out_pl, (tables.placements, ids_pl), mesh,
                        tables, ids)


# --------------------------------------------------------------------- #
# DLRM (arXiv:1906.00091), RM2 scale
# --------------------------------------------------------------------- #
def dlrm_forward(model: DLRM, dense: torch.Tensor, sparse_ids: torch.Tensor
                 ) -> torch.Tensor:
    """dense [B, 13] f32; sparse_ids [B, 26] int32 → logits [B]."""
    d = _mlp_apply(model.bot, dense.to(model.tables.dtype), final_act=True)
    emb = _field_lookup(model.tables, sparse_ids)            # [B, F, D]
    feats = torch.cat([d[:, None, :], emb], dim=1)           # [B, F+1, D]
    inter = torch.bmm(feats, feats.transpose(1, 2))
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=feats.device)
    pairs = per_row(lambda t: t[:, iu, ju], inter)           # [B, n_pairs]
    z = torch.cat([d, pairs.to(d.dtype)], dim=1)
    return _mlp_apply(model.top, z)[:, 0]


# --------------------------------------------------------------------- #
# xDeepFM (arXiv:1803.05170)
# --------------------------------------------------------------------- #
def xdeepfm_forward(model: XDeepFM, sparse_ids: torch.Tensor
                    ) -> torch.Tensor:
    """sparse_ids [B, F] → logits [B]."""
    b = sparse_ids.shape[0]
    emb = _field_lookup(model.tables, sparse_ids)            # [B, F, D]
    x0 = xk = emb
    xs: List[torch.Tensor] = []
    for w in model.cin:
        # "bhd,bmd->bhmd", then [B, H·F, D] in that order
        z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(
            b, -1, model.cfg.embed_dim)
        xk = torch.matmul(w, z)                              # [B, H, D]
        xs.append(xk.sum(dim=-1))                            # sum-pool over D
    cin_feat = torch.cat(xs, dim=-1)                         # [B, ΣH]
    y_cin = torch.matmul(cin_feat, model.cin_out)[:, 0]
    y_dnn = _mlp_apply(model.mlp, emb.reshape(b, -1))[:, 0]
    lin = _field_lookup(model.linear, sparse_ids)            # [B, F, 1]
    return y_cin + y_dnn + lin.sum(dim=(1, 2))


# --------------------------------------------------------------------- #
# two-tower retrieval (Yi et al., RecSys'19)
# --------------------------------------------------------------------- #
def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def twotower_user_embed(model: TwoTower, user_ids: torch.Tensor,
                        hist_ids: torch.Tensor, hist_w: torch.Tensor
                        ) -> torch.Tensor:
    """User row plus the weighted bag of the history's item rows, through
    the user tower, unit norm → [B, tower_mlp[-1]]."""
    u = _take(model.user_table, user_ids)
    u = u + bag_ops.embedding_bag_padded(model.item_table, hist_ids, hist_w)
    return _unit(_mlp_apply(model.user_tower, u))


def twotower_item_embed(model: TwoTower, item_ids: torch.Tensor
                        ) -> torch.Tensor:
    return _unit(_mlp_apply(model.item_tower,
                            _take(model.item_table, item_ids)))


def twotower_score_candidates(model: TwoTower, batch: Dict[str, torch.Tensor]
                              ) -> torch.Tensor:
    """retrieval_cand: each query against ``cand_ids`` → [B, n_cand] f32."""
    u = twotower_user_embed(model, batch["user_ids"], batch["hist_ids"],
                            batch["hist_w"])
    i = twotower_item_embed(model, batch["cand_ids"])
    return _wide(torch.matmul(u, i.T))


# --------------------------------------------------------------------- #
# SASRec (arXiv:1808.09781)
# --------------------------------------------------------------------- #
def _ln(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = _wide(x)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g


def sasrec_encode(model: SASRec, item_seq: torch.Tensor) -> torch.Tensor:
    """item_seq [B, S] (0 = padding) → hidden [B, S, D], padding rows 0."""
    cfg = model.cfg
    s = item_seq.shape[1]
    x = _take(model.item_embed, item_seq)
    x = x + model.pos_embed[None, :s]
    mask = item_seq != 0
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))
    allowed = causal[None] & mask[:, None, :]
    # the reference divides float32 scores by np.sqrt(D), a float64 that
    # JAX without x64 takes as float32
    scale = float(np.float32(np.sqrt(cfg.embed_dim)))
    bp = model.blocks
    for i in range(cfg.n_blocks):
        xn = _ln(x, bp.ln1[i])
        q = torch.matmul(xn, bp.wq[i])
        k = torch.matmul(xn, bp.wk[i])
        v = torch.matmul(xn, bp.wv[i])
        scores = torch.bmm(_wide(q), _wide(k).transpose(1, 2)) / scale
        scores = torch.where(allowed, scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        x = x + torch.matmul(torch.bmm(p, _wide(v)).to(x.dtype), bp.wo[i])
        xn = _ln(x, bp.ln2[i])
        x = x + torch.matmul(torch.relu(torch.matmul(xn, bp.ff1[i])),
                             bp.ff2[i])
    return x * mask[..., None]


def sasrec_score_candidates(model: SASRec, batch: Dict[str, torch.Tensor]
                            ) -> torch.Tensor:
    """Candidates ``cand_ids`` ([C] shared, or [B, C]) scored against the
    hidden state at position len − 1 (fault (i): see the module's doc) →
    [B, C] f32."""
    item_seq = batch["item_seq"]
    h = sasrec_encode(model, item_seq)                       # [B, S, D]
    lengths = (item_seq != 0).sum(-1)
    last = h[torch.arange(h.shape[0], device=h.device),
             torch.clamp(lengths - 1, min=0)]                # [B, D]
    cand = _take(model.item_embed, batch["cand_ids"])
    if cand.dim() == 2:                                      # shared cands
        return _wide(torch.matmul(last, cand.T))
    return _wide(torch.einsum("bd,bcd->bc", last, cand))


# --------------------------------------------------------------------- #
# training losses
# --------------------------------------------------------------------- #
def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    logits = _wide(logits)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def dlrm_loss(model: DLRM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = dlrm_forward(model, batch["dense"], batch["sparse"])
    return bce_with_logits(logits, batch["labels"])


def xdeepfm_loss(model: XDeepFM, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    logits = xdeepfm_forward(model, batch["sparse"])
    return bce_with_logits(logits, batch["labels"])


TEMPERATURE = 20.0


class _StreamedLogZ(torch.autograd.Function):
    """logz[b] = logsumexp_j (20 · u_b·i_j − logq_j), streamed over item
    chunks of ``c`` with a running max and sum (the reference's
    ``loss_chunk`` scan, ``recsys.py:235-252``).  Saves only u, i, logq,
    and the running (m, s); the backward recomputes each [B, c] block of
    the softmax, so the [B, B] logits are never held in either pass."""

    @staticmethod
    def forward(ctx, u, i, logq, c):
        b = u.shape[0]
        acc_t = torch.promote_types(u.dtype, torch.float32)
        m = torch.full((b,), -1e30, dtype=acc_t, device=u.device)
        s = torch.zeros((b,), dtype=acc_t, device=u.device)
        for lo in range(0, b, c):
            lg = (_wide(torch.matmul(u, i[lo:lo + c].T)) * TEMPERATURE
                  - logq[None, lo:lo + c])
            m_new = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(-1)
            m = m_new
        ctx.save_for_backward(u, i, logq, m, s)
        ctx.c = c
        return m + torch.log(torch.clamp(s, min=1e-30))

    @staticmethod
    def backward(ctx, g):
        u, i, logq, m, s = ctx.saved_tensors
        c = ctx.c
        logz = m + torch.log(torch.clamp(s, min=1e-30))
        gu = torch.zeros_like(u, dtype=torch.promote_types(u.dtype,
                                                           torch.float32))
        gi = torch.zeros_like(gu)
        for lo in range(0, u.shape[0], c):
            lg = (_wide(torch.matmul(u, i[lo:lo + c].T)) * TEMPERATURE
                  - logq[None, lo:lo + c])
            w = torch.exp(lg - logz[:, None]) * g[:, None] * TEMPERATURE
            w = w.to(u.dtype)
            gu += torch.matmul(w, i[lo:lo + c])
            gi[lo:lo + c] = torch.matmul(w.T, u)
        return gu.to(u.dtype), gi.to(i.dtype), None, None


def twotower_loss(model: TwoTower, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (temperature 20).
    With ``loss_chunk`` set and a batch larger than it, the log normalizer
    streams over item chunks (:class:`_StreamedLogZ`); the batch must be a
    multiple of the chunk, as the reference's reshape needs."""
    cfg = model.cfg
    u = twotower_user_embed(model, batch["user_ids"], batch["hist_ids"],
                            batch["hist_w"])
    i = twotower_item_embed(model, batch["item_ids"])
    logq = batch.get("logq")
    b = u.shape[0]
    gold = _wide((u * i).sum(dim=-1)) * TEMPERATURE
    if logq is not None:
        gold = gold - logq
    if not cfg.loss_chunk or b <= cfg.loss_chunk:
        logits = _wide(torch.matmul(u, i.T)) * TEMPERATURE
        if logq is not None:
            logits = logits - logq[None, :]
        logz = torch.logsumexp(logits, dim=-1)
        return torch.mean(logz - gold)
    if b % cfg.loss_chunk:
        raise ValueError(f"batch {b} is not a multiple of loss_chunk "
                         f"{cfg.loss_chunk}")
    lq = logq if logq is not None else torch.zeros(
        (b,), dtype=gold.dtype, device=u.device)
    logz = _StreamedLogZ.apply(u, i, lq, cfg.loss_chunk)
    return torch.mean(logz - gold)


def sasrec_loss(model: SASRec, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """Next-item BCE with sampled negatives (the paper's objective), in the
    reference's form: log1p(exp(−pos)) + log1p(exp(neg)), masked where
    ``pos_items`` is 0."""
    h = sasrec_encode(model, batch["item_seq"])              # [B, S, D]
    pos = _take(model.item_embed, batch["pos_items"])
    neg = _take(model.item_embed, batch["neg_items"])
    pos_logit = _wide((h * pos).sum(dim=-1))
    neg_logit = _wide((h * neg).sum(dim=-1))
    mask = (batch["pos_items"] != 0).to(pos_logit.dtype)
    loss = torch.log1p(torch.exp(-pos_logit)) + torch.log1p(
        torch.exp(neg_logit))
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
