"""GQA transformer LM (dense and MoE) in PyTorch: the JAX package's
``repro.models.transformer`` (forward and loss for training; prefill and
decode for serving).

Covers qwen2.5 / yi / internlm2 (dense GQA, optional QKV bias, optional
QK-norm) and qwen3-moe / qwen2-moe (top-k routed experts with a capacity,
optional shared expert): :func:`moe_block` in place of the SwiGLU MLP.

A model is a :class:`Transformer` module holding one :class:`DecoderLayer`
per layer (the JAX package stacks layer leaves along [L] and scans; eager
PyTorch walks a list).  Weights keep the JAX ``[in, out]`` layout and the
products are ``x @ w``, so :func:`repro_torch.convert.transformer_from_jax`
copies leaves without a transpose.  Parameters are made without gradients
(serving); the trainer turns them on for the model it trains.
``forward`` builds a graph when grad mode is on; ``prefill`` and
``decode_step`` never do.  ``remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``),
and ``attn_chunk_q`` / ``attn_chunk_kv`` run the blocked attention.

Each :func:`decode_step` and :func:`prefill` call is one trace of
``repro_torch.obs`` spans while tracing is on (``lm.decode_step`` or
``lm.prefill``, and in each layer ``lm.attention``, ``lm.gqa_decode`` in
decode, ``lm.mlp`` or ``lm.moe`` with ``lm.moe.dispatch``), and
:data:`MOE_COUNTS` sums the MoE counters on the device while the registry
is on; ``repro_torch.obs.timeline`` puts device time and device idle time
down to the spans.

Where a line-by-line port goes wrong, and what this one does:

- the KV write at ``length`` drops rows whose ``length >= S`` (JAX
  ``.at[].set(mode="drop")``); torch's indexed write would raise or
  assert, so each row writes back its old value there instead, on the
  device and without a host sync (:func:`decode_step`);
- RoPE positions past ``max_seq_len`` clamp to its last row, as JAX's
  gather does (``layers.apply_rope``); the table is built once per model
  and device, where the reference rebuilds it in every traced step;
- the cache is updated in place (at 32k one copy is 25.8 GB for
  Qwen2.5-14B), where JAX returns a new one;
- the reference's init takes each stacked weight's fan-in from its layer
  axis, so its scale is 1/√L; :func:`init_params` draws the same
  distribution, one layer at a time;
- the reference fills each expert's token buffer with one scatter on
  duplicate indices: a token past its expert's capacity writes the empty
  sentinel into the expert's last slot, and on the CPU the update with
  the largest flat index ``t·K + k`` wins, so a token kept in that slot
  can lose its expert's output.  :func:`moe_dispatch` resolves each
  slot's winner by that rule with an integer ``amax`` (a scatter on
  duplicate indices leaves the winner undefined on CUDA), so the
  dispatch is the same on either device and equal to the reference's;
- on DTensors (a mesh, ``dist.sharding``) DTensor picks each operator's
  layout alone where the reference's compiler plans the step, so the
  lookups, the cache write, the dispatch and a few layouts go through
  ``dist.on_mesh`` (each a no-op on plain tensors).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.core.vectorized import stable_topk
from repro_torch.dist.on_mesh import (add_settled, grad_like, is_dtensor,
                                      keep_shards, local_range, logits_layout,
                                      placed_alike, replicated_local,
                                      settled, split_last, take_rows)
from repro_torch.dist.sharding import placements
from repro_torch.kernels.gqa_decode import kernel as gqa_kernel

from .layers import (apply_rope, causal_gqa_attention,
                     chunked_causal_gqa_attention, cross_entropy_loss,
                     rms_norm, rope_frequencies, rope_rotate, swiglu)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0           # shared experts (qwen2-moe style)
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True   # normalize top-k probabilities


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    max_seq_len: int = 32_768
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True        # recompute each layer in the backward
    # flash-style blocked attention chunk sizes (0 = off); the JAX
    # config's scan_unroll steers its compiler and has no counterpart here
    attn_chunk_q: int = 0
    attn_chunk_kv: int = 0
    # "" | "all" | "combine": the reference's sharding constraints inside
    # moe_block, here a redistribute of DTensors (nothing off a mesh)
    moe_shard: str = ""

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Total (and active) parameter counts for roofline MODEL_FLOPS."""
        d, hd = self.d_model, self.head_dim
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
        if self.moe is None:
            mlp = 3 * d * self.d_ff
        else:
            mlp = (self.moe.n_experts * 3 * d * self.moe.d_expert_ff
                   + d * self.moe.n_experts
                   + (3 * d * self.moe.d_shared_ff if self.moe.n_shared
                      else 0))
        emb = self.vocab * d * 2
        return self.n_layers * (attn + mlp + 2 * d) + emb + d

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d, hd = self.d_model, self.head_dim
        attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d)
        mlp = (self.moe.top_k * 3 * d * self.moe.d_expert_ff
               + d * self.moe.n_experts
               + (3 * d * self.moe.d_shared_ff if self.moe.n_shared else 0))
        emb = self.vocab * d * 2
        return self.n_layers * (attn + mlp + 2 * d) + emb + d


def layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """One layer's parameter shapes by the JAX package's leaf names."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {"attn_norm": (d,), "mlp_norm": (d,), "wq": (d, h * hd),
              "wk": (d, hkv * hd), "wv": (d, hkv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    m = cfg.moe
    if m is None:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
        return shapes
    e, f = m.n_experts, m.d_expert_ff
    shapes.update(router=(d, e), e_gate=(e, d, f), e_up=(e, d, f),
                  e_down=(e, f, d))
    if m.n_shared:
        fs = m.d_shared_ff
        shapes.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d),
                      s_gate_proj=(d, 1))
    return shapes


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights, named as the JAX package's layer leaves."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            self.register_parameter(name,
                                    _param(shape, cfg.torch_dtype, device))

    def tensors(self, dtype: Optional[torch.dtype] = None
                ) -> Mapping[str, torch.Tensor]:
        """The weights by name, widened to ``dtype`` if one is given."""
        if dtype is None:
            return self._parameters
        return {n: p.to(dtype) for n, p in self._parameters.items()}


class Transformer(nn.Module):
    """Embedding, ``n_layers`` decoder layers, final norm, LM head, and the
    RoPE table for ``max_seq_len`` positions on the model's device.  The
    parameters are uninitialised: see :func:`init_params` and
    :func:`repro_torch.convert.transformer_from_jax`."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), dt, device)
        self.lm_head = _param((cfg.d_model, cfg.vocab), dt, device)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def rope(self, s: int):
        """(cos, sin) with at least ``s`` rows."""
        if s <= self.cfg.max_seq_len:
            return self.rope_cos, self.rope_sin
        return rope_frequencies(self.cfg.head_dim, s, self.cfg.rope_theta,
                                self.device)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
@torch.no_grad()
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A model with random weights drawn from ``generator`` (which must
    live on ``device``), with the JAX package's distribution: norms 1,
    biases 0, the embedding N(0, 0.02²), the LM head N(0, 1/d_model), and
    every stacked layer weight N(0, 1/n_layers), the MoE router, experts
    and shared-expert gate included — the reference takes the fan-in of a
    stacked ``[L, ...]`` leaf from its first axis.  Draws one layer at a
    time in float32, so no float32 copy of a stacked weight is ever
    held.  The numbers differ from the JAX init's (another
    generator); the reference also draws embedding and LM head from one
    key, this draws them independently."""
    model = Transformer(cfg, device)
    dev = model.device

    def normal(p: torch.Tensor, scale: float):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale)

    layer_scale = 1.0 / np.sqrt(cfg.n_layers)
    for layer in model.layers:
        for name, p in layer.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name in ("bq", "bk", "bv"):
                p.zero_()
            else:
                normal(p, layer_scale)
    normal(model.embed, 0.02)
    model.final_norm.fill_(1.0)
    normal(model.lm_head, 1.0 / np.sqrt(cfg.d_model))
    return model


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _qkv(cfg: TransformerConfig, lp: Mapping[str, torch.Tensor],
         xn: torch.Tensor):
    """Projections of the normed input: q [B, S, Hkv, G, Dh], k and v
    [B, S, Hkv, Dh], QK-normed when the config says so, before RoPE."""
    b, s, _ = xn.shape
    hkv, g, hd = cfg.n_kv_heads, cfg.group_size, cfg.head_dim
    # on DTensors whose q/k/v weights are cut differently (FSDP's cut
    # lands on another dimension of a wide wq than of a narrow wk) the
    # products' gradients of xn come back in different layouts: each is
    # placed as xn is before autograd adds them (see moe_block)
    own = not placed_alike(lp["wq"], lp["wk"], lp["wv"])
    q = torch.matmul(grad_like(xn) if own else xn, lp["wq"])
    k = torch.matmul(grad_like(xn) if own else xn, lp["wk"])
    v = torch.matmul(grad_like(xn) if own else xn, lp["wv"])
    if cfg.qkv_bias:    # on DTensors: see recsys._mlp_apply
        q, k, v = (settled(q) + lp["bq"], settled(k) + lp["bk"],
                   settled(v) + lp["bv"])
    q = split_last(q, hkv, g, hd)
    k = split_last(k, hkv, hd)
    v = split_last(v, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return q, k, v


# --------------------------------------------------------------------- #
# MoE dispatch (the reference's gather formulation)
# --------------------------------------------------------------------- #
def capacity(t: int, m: MoEConfig) -> int:
    """Slots an expert has for ``t`` tokens: the reference's expression,
    in Python floats (integer arithmetic rounds otherwise where
    T·K/E·capacity_factor lands near an integer)."""
    return max(int(np.ceil(t * m.top_k / m.n_experts * m.capacity_factor)), 1)


def moe_dispatch(probs: torch.Tensor, m: MoEConfig,
                 top_e: Optional[torch.Tensor] = None):
    """The integer half of :func:`moe_block`: router probabilities
    ``probs`` [T, E] (float32) → (``top_p`` [T, K] float32, ``top_e``
    [T, K], ``pos`` [T, K], ``keep`` [T, K] bool, ``idx_buf`` [E, C]).

    ``top_e`` are the K most probable experts, ties to the lower index
    (``lax.top_k``), unless given (another run's routing, which a
    reference replay keeps); ``top_p`` their probabilities, divided by
    their sum (added in slot order, as XLA does) where
    ``router_norm_topk`` is set.
    Positions are slot-major: assignment (t, k) on expert e sits after
    every assignment to e of slots 0..k-1 and of the tokens before t in
    slot k.  ``keep = pos < C``.  ``idx_buf[e, c]`` holds the token that
    expert e computes in slot c, or the sentinel T: of the assignments
    that write the slot (the kept one at c, and every dropped one on e at
    c = C-1) the one with the largest flat index t·K + k wins, and a
    dropped winner leaves the sentinel — the reference's scatter on the
    CPU (fault (t)).  All integer work, with no host sync: the same bits
    on the card and on the host.
    """
    t, e = probs.shape
    k = m.top_k
    c = capacity(t, m)
    if top_e is None:
        top_p, top_e = stable_topk(probs, k)
    else:
        top_p = probs.gather(1, top_e)
    if m.router_norm_topk:
        total = top_p[:, 0]
        for i in range(1, k):
            total = total + top_p[:, i]
        top_p = top_p / torch.clamp(total, min=1e-9)[:, None]
    # slot-major one-hot [K·T, E]; its running count is each position
    slots = top_e.t().reshape(-1)
    onehot = (slots[:, None] == torch.arange(e, device=probs.device)
              ).to(torch.int32)
    pos = (onehot.cumsum(0).gather(1, slots[:, None])[:, 0] - 1
           ).view(k, t).t()
    keep = pos < c
    slot = top_e * c + torch.where(keep, pos, c - 1)
    flat = torch.arange(t * k, device=probs.device)
    win = torch.full((e * c,), -1, dtype=torch.int64, device=probs.device)
    win.scatter_reduce_(0, slot.reshape(-1), flat, "amax")
    won = (win >= 0) & keep.reshape(-1)[win.clamp(min=0)]
    idx_buf = torch.where(won, win // k, t).view(e, c)
    return top_p, top_e, pos, keep, idx_buf


class MoECounts:
    """The MoE counters of every :func:`moe_block` call while the
    registry is enabled (a remat backward's recompute counts again):
    assignments kept and dropped, kept assignments lost to a dropped
    winner of their slot (fault (t)), and expert slots computed (E·C).
    Kept assignments and slots with a kept winner are summed on the
    device the call ran on, without a sync; :meth:`flush` reads them with
    one sync a device and adds all four to the registry's counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sums: Dict[torch.device, torch.Tensor] = {}  # [kept, won]
        self._assignments = 0
        self._slots = 0

    def add(self, keep: torch.Tensor, idx_buf: torch.Tensor, t: int
            ) -> None:
        """One call's ``keep`` [T, K] and ``idx_buf`` [E, C] (sentinel
        ``t``) from :func:`moe_dispatch`."""
        if is_dtensor(keep):        # replicated: the whole on every rank
            keep, idx_buf = keep.to_local(), idx_buf.to_local()
        both = torch.stack((keep.sum(), (idx_buf < t).sum()))
        with self._lock:
            acc = self._sums.get(both.device)
            if acc is None:
                self._sums[both.device] = both
            else:
                acc.add_(both)
            self._assignments += keep.numel()
            self._slots += idx_buf.numel()

    def flush(self) -> Dict[str, int]:
        """The counts since the last flush, added to the registry's
        counters (one host sync a device that holds sums).  The registry
        calls it before each export, so ``/metrics`` and a snapshot at
        the end of a window carry the counts up to that point."""
        with self._lock:
            sums, self._sums = self._sums, {}
            assignments, self._assignments = self._assignments, 0
            slots, self._slots = self._slots, 0
        kept = won = 0
        for acc in sums.values():
            k, w = acc.tolist()
            kept, won = kept + k, won + w
        out = {"kept": kept, "dropped": assignments - kept,
               "lost": kept - won, "slots": slots}
        if not slots:       # no MoE call since the last flush
            return out
        reg = obs.registry()
        reg.counter("lm_moe_assignments_kept_total").inc(out["kept"])
        reg.counter("lm_moe_assignments_dropped_total").inc(out["dropped"])
        reg.counter("lm_moe_kept_lost_total").inc(out["lost"])
        reg.counter("lm_moe_slots_total").inc(out["slots"])
        return out


MOE_COUNTS = MoECounts()
obs.registry().add_collector(MOE_COUNTS.flush)


def moe_block(x: torch.Tensor, lp: Mapping[str, torch.Tensor],
              cfg: TransformerConfig) -> torch.Tensor:
    """x [T, D] (token-major) → [T, D], the reference's ``moe_block``.

    The router runs in float32.  Every expert computes its [C, D] buffer
    (empty slots hold a zero row); each (t, k) gathers its slot's output
    and is weighted by ``top_p · keep``, so a dropped or overwritten
    assignment adds a zero, and a non-finite expert output reaches the
    tokens that gather it, as in the reference.  The shared expert
    (qwen2-moe) is gated by a float32 sigmoid."""
    m = cfg.moe
    t, d = x.shape
    with obs.span("lm.moe.dispatch"):
        # on DTensors each use of x takes its own grad_like: the gradients
        # of the router, the experts and the shared expert come back
        # placed as x is before autograd adds them (DTensor's add of a
        # pending sum and a cut may ask to turn the cut into a pending
        # sum, which some versions cannot do); a no-op on plain tensors
        probs = torch.softmax(torch.matmul(grad_like(x).float(),
                                           lp["router"].float()), dim=-1)
        if is_dtensor(probs):  # integer work on [T, E]: whole on every rank
            top_p, top_e, pos, keep, idx_buf = replicated_local(
                lambda pr: moe_dispatch(pr, m), 5, probs)
        else:
            top_p, top_e, pos, keep, idx_buf = moe_dispatch(probs, m)
        if obs.registry().enabled:
            MOE_COUNTS.add(keep, idx_buf, t)
    c = idx_buf.shape[1]
    xe = torch.cat([grad_like(x), x.new_zeros((1, d))])[idx_buf]  # [E, C, D]
    if cfg.moe_shard == "all":
        xe = _constrain(xe, ("model", "data", None))
    # on DTensors the pending sums of the experts' products are reduced
    # before the next product (a sum times a cut weight has no strategy)
    h = settled(F.silu(torch.bmm(xe, lp["e_gate"]))
                * torch.bmm(xe, lp["e_up"]))
    ye = settled(torch.bmm(h, lp["e_down"]))                  # [E, C, D]
    if cfg.moe_shard == "all":
        ye = _constrain(ye, ("model", "data", None))
    y_slots = ye[top_e, torch.where(keep, pos, c - 1)]        # [T, K, D]
    if cfg.moe_shard:
        y_slots = _constrain(y_slots, ("data", None, None))
    w = (top_p * keep).to(ye.dtype)
    y = torch.bmm(w[:, None, :], y_slots)[:, 0]
    if m.n_shared:
        g = torch.sigmoid(torch.matmul(grad_like(x).float(),
                                       lp["s_gate_proj"].float()))
        y = add_settled(y, g.to(x.dtype) * swiglu(
            grad_like(x), lp["s_gate"], lp["s_up"], lp["s_down"]))
    return y.to(x.dtype)


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint(x, P(*spec))``: a DTensor
    redistributed to ``spec``'s placements on its mesh (an axis the mesh
    lacks is left out); any other tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    spec = tuple(a if a in names else None for a in spec)
    return x.redistribute(mesh, placements(mesh, spec))


def _mlp(cfg: TransformerConfig, x: torch.Tensor,
         lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    x = keep_shards(x, (0,))     # on DTensors: see _layer
    if cfg.moe is None:
        with obs.span("lm.mlp"):
            return x + swiglu(rms_norm(x, lp["mlp_norm"]), lp["w_gate"],
                              lp["w_up"], lp["w_down"])
    with obs.span("lm.moe"):
        xn = rms_norm(x, lp["mlp_norm"])
        b, s, d = xn.shape
        return add_settled(x, moe_block(xn.reshape(b * s, d), lp, cfg
                                        ).reshape(b, s, d))


def _layer(cfg: TransformerConfig, cos, sin, x: torch.Tensor,
           lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    # on DTensors the residual stream keeps only its batch cut: DTensor's
    # op-by-op choices would cut the sequence too, and the products'
    # flatten of a cut batch and sequence is a strided shard it cannot
    # multiply
    x = keep_shards(x, (0,))
    b, s, _ = x.shape
    with obs.span("lm.attention"):
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["attn_norm"]))
        q = apply_rope(q.reshape(b, s, -1, cfg.head_dim), cos, sin
                       ).reshape(q.shape)
        k = apply_rope(k, cos, sin)
        if cfg.attn_chunk_q and s > cfg.attn_chunk_q:
            q_chunk = min(cfg.attn_chunk_q, s)
            kv_chunk = min(cfg.attn_chunk_kv or cfg.attn_chunk_q, s)
            if s % q_chunk or s % kv_chunk:
                raise ValueError(f"sequence {s} is not a multiple of the "
                                 f"attention chunks ({q_chunk}, {kv_chunk})")
            attn = chunked_causal_gqa_attention(q, k, v, q_chunk=q_chunk,
                                                kv_chunk=kv_chunk)
        else:
            attn = causal_gqa_attention(q, k, v)
        # on DTensors the heads' gradient comes back placed as the flat
        # heads are, so the flatten's backward can split it again
        attn = grad_like(attn.reshape(b, s, -1))
        x = add_settled(x, torch.matmul(attn, lp["wo"]))
    return _mlp(cfg, x, lp)


def _layer_remat(cfg: TransformerConfig, cos, sin, x: torch.Tensor,
                 layer: "DecoderLayer") -> torch.Tensor:
    """One layer whose activations are recomputed in the backward."""
    def body(x, *weights):
        return _layer(cfg, cos, sin, x, dict(zip(names, weights)))
    names = list(layer.tensors())
    return checkpoint(body, x, *layer.tensors().values(),
                      use_reentrant=False)


def forward(model: Transformer, tokens: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V]; a graph is built when grad mode
    is on, each layer under ``checkpoint`` where ``cfg.remat`` is set.

    With ``dtype`` (e.g. float32 for a reference run of a bfloat16 model),
    every weight is widened to it just before use, one layer at a time.
    """
    cfg = model.cfg
    b, s = tokens.shape
    cos, sin = model.rope(s)
    x = take_rows(model.embed, tokens)
    if dtype is not None:
        x = x.to(dtype)
    remat = (cfg.remat and dtype is None and torch.is_grad_enabled()
             and model.embed.requires_grad)
    for layer in model.layers:
        if remat:
            x = _layer_remat(cfg, cos, sin, x, layer)
        else:
            x = _layer(cfg, cos, sin, x, layer.tensors(dtype))
    norm, head = model.final_norm, model.lm_head
    if dtype is not None:
        norm, head = norm.to(dtype), head.to(dtype)
    return logits_layout(torch.matmul(rms_norm(x, norm), head))


def loss_fn(model: Transformer, batch) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` ([B, S] each), in float32."""
    logits = forward(model, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"])


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward (logits only)."""
    with obs.span("lm.prefill"):
        return forward(model, tokens)


# --------------------------------------------------------------------- #
# decode path: one token in, KV cache of seq_len
# --------------------------------------------------------------------- #
def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device=None, dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """An empty KV cache in the model's dtype, or in ``dtype`` for a
    :func:`decode_step` run with widened weights."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.torch_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def _cache_rows(b: int, s_loc: int, at: torch.Tensor):
    """The flat rows [B] of a cache [B, S', ...] that the write at
    positions ``at`` [B] (relative to the cache's first position) lands
    on, clamped into it, and the mask [B, 1] of rows whose position falls
    in it (the others, at or past the cache's end or before its start,
    rewrite their old value, as JAX's dropped write)."""
    mine = ((at >= 0) & (at < s_loc))[:, None]
    row = (torch.arange(b, device=at.device) * s_loc
           + at.clamp(min=0, max=s_loc - 1))
    return row, mine


def _write_rows(kv: torch.Tensor, new: torch.Tensor, row: torch.Tensor,
                mine: torch.Tensor) -> torch.Tensor:
    """kv [B, S', Hkv, D]: flat row ``row[b]`` takes ``new[b]`` where
    ``mine[b]``, and its old value elsewhere."""
    flat = kv.view(kv.shape[0] * kv.shape[1], -1)
    flat.index_copy_(0, row, torch.where(mine, new, flat.index_select(0, row)))
    return kv


def _write_kv_on_mesh(kv: torch.Tensor, new: torch.Tensor,
                      length: torch.Tensor) -> None:
    """One layer's cache write of :func:`decode_step` on a DTensor cache,
    in place: each rank writes the rows and positions it holds (the
    batch-sharded cache its rows, the sequence-sharded one its range of
    positions).  ``new`` [B, Hkv·D] and ``length`` come whole on the
    dimensions the cache shards by position, as the cache on the others."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    s_lo, _ = local_range(kv, 1)
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in kv.placements]
    new_pl = [Shard(1) if p == Shard(2) else Replicate() if p == Shard(1)
              else p for p in kv.placements]

    def write(kl, nl, ll):
        return _write_rows(kl, nl, *_cache_rows(kl.shape[0], kl.shape[1],
                                                ll - s_lo))
    local_map(write, out_placements=list(kv.placements),
              in_placements=(kv.placements, new_pl, rows),
              device_mesh=kv.device_mesh, redistribute_inputs=True)(
        kv, new, length)


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """tokens [B] (one new token per sequence) → (logits [B, V], cache).

    Updates ``cache`` in place and returns it: each layer's new K and V
    are written at position ``length`` (rows whose ``length`` is at or past
    the cache's end keep their old values, as JAX's dropped write), and
    ``length`` grows by one for every row.  Attention runs through the
    ``gqa_decode`` kernel wrapper, once per layer.  An MoE layer routes
    the step's B tokens together (T = B, so the capacity is that of B
    tokens).

    With ``dtype`` (a float32 reference run of a bfloat16 model, against
    a cache of that dtype), every weight is widened to it just before use,
    one layer at a time, as :func:`forward` does; serving never passes it.
    """
    with obs.span("lm.decode_step"):
        logits = _decode_logits(model, cache, tokens, dtype)
    return logits, cache


def _decode_logits(model: Transformer, cache: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, dtype: Optional[torch.dtype]
                   ) -> torch.Tensor:
    """:func:`decode_step`'s body: the logits [B, V], the cache updated."""
    cfg = model.cfg
    b = tokens.shape[0]
    length = cache["length"]
    # per step, not per layer: the RoPE rows at each row's position
    # (clamped to the table, as JAX's gather)
    pos = length.clamp(max=cfg.max_seq_len - 1)[:, None]    # [B, 1]
    c = take_rows(model.rope_cos, pos)[..., None, :]
    sn = take_rows(model.rope_sin, pos)[..., None, :]
    attend = length + 1
    # a plain cache's flat write rows, once a step; a DTensor cache's
    # rank-local ones in each layer's write
    on_mesh = is_dtensor(cache["k"])
    if not on_mesh:
        row, mine = _cache_rows(b, cache["k"].shape[2], length)
    x = take_rows(model.embed, tokens)[:, None, :]          # [B, 1, D]
    if dtype is not None:
        x = x.to(dtype)
    for li, layer in enumerate(model.layers):
        lp = layer.tensors(dtype)
        with obs.span("lm.attention"):
            q, k, v = _qkv(cfg, lp, rms_norm(x, lp["attn_norm"]))
            q = rope_rotate(q.reshape(b, 1, -1, cfg.head_dim), c, sn
                            ).reshape(q.shape)
            k = rope_rotate(k, c, sn)
            k_cache, v_cache = cache["k"][li], cache["v"][li]
            for kv, new in ((k_cache, k), (v_cache, v)):
                if on_mesh:
                    _write_kv_on_mesh(kv, new.reshape(b, -1), length)
                else:
                    _write_rows(kv, new.reshape(b, -1), row, mine)
            with obs.span("lm.gqa_decode"):
                attn = gqa_kernel.gqa_decode(q[:, 0], k_cache, v_cache,
                                             attend)
            x = add_settled(x, torch.matmul(attn.reshape(b, 1, -1),
                                            lp["wo"]))
        x = _mlp(cfg, x, lp)
    norm, head = model.final_norm, model.lm_head
    if dtype is not None:
        norm, head = norm.to(dtype), head.to(dtype)
    logits = logits_layout(torch.matmul(rms_norm(x, norm), head))
    length.add_(1)
    return logits[:, 0]
