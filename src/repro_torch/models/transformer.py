"""GQA transformer LM, dense, in PyTorch: the JAX package's
``repro.models.transformer`` for serving (forward, prefill, decode).

Covers qwen2.5 / yi / internlm2 (dense GQA, optional QKV bias, optional
QK-norm).  The MoE configurations (qwen3-moe, qwen2-moe) need
``moe_block``, which is not ported yet: building their model raises.

A model is a :class:`Transformer` module holding one :class:`DecoderLayer`
per layer (the JAX package stacks layer leaves along [L] and scans; eager
PyTorch walks a list).  Weights keep the JAX ``[in, out]`` layout and the
products are ``x @ w``, so :func:`repro_torch.convert.transformer_from_jax`
copies leaves without a transpose.  Parameters are made without gradients:
this module serves.

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
  distribution, one layer at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.gqa_decode import kernel as gqa_kernel

from .layers import (apply_rope, causal_gqa_attention, rms_norm,
                     rope_frequencies, rope_rotate, swiglu)


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
    # flash-style blocked attention, not ported: a prompt longer than a
    # set chunk raises in forward.  The JAX config's remat, scan_unroll,
    # attn_chunk_kv and moe_shard steer its compiler and sharding and have
    # no counterpart here.
    attn_chunk_q: int = 0

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
    shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                  w_down=(cfg.d_ff, d))
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
        if cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.name} is a mixture-of-experts configuration: "
                f"moe_block is not ported yet (the MoE slice of the port, "
                f"see ROADMAP.md); it is never run as a dense model")
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
    every stacked layer weight N(0, 1/n_layers) — the reference takes the
    fan-in of a stacked ``[L, in, out]`` leaf from its first axis.  Draws
    one layer at a time in float32, so no float32 copy of a stacked weight
    is ever held.  The numbers differ from the JAX init's (another
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
    q = torch.matmul(xn, lp["wq"])
    k = torch.matmul(xn, lp["wk"])
    v = torch.matmul(xn, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, hkv, g, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return q, k, v


def _mlp(x: torch.Tensor, lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    xn = rms_norm(x, lp["mlp_norm"])
    return x + swiglu(xn, lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer(cfg: TransformerConfig, cos, sin, x: torch.Tensor,
           lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, rms_norm(x, lp["attn_norm"]))
    q = apply_rope(q.reshape(b, s, -1, cfg.head_dim), cos, sin
                   ).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    attn = causal_gqa_attention(q, k, v).reshape(b, s, -1)
    return _mlp(x + torch.matmul(attn, lp["wo"]), lp)


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V].

    With ``dtype`` (e.g. float32 for a reference run of a bfloat16 model),
    every weight is widened to it just before use, one layer at a time.
    """
    cfg = model.cfg
    b, s = tokens.shape
    if cfg.attn_chunk_q and s > cfg.attn_chunk_q:
        raise NotImplementedError(
            "chunked causal attention (attn_chunk_q) is not ported yet: it "
            "belongs to the training and long-prefill slice")
    cos, sin = model.rope(s)
    x = model.embed[tokens]
    if dtype is not None:
        x = x.to(dtype)
    for layer in model.layers:
        x = _layer(cfg, cos, sin, x, layer.tensors(dtype))
    norm, head = model.final_norm, model.lm_head
    if dtype is not None:
        norm, head = norm.to(dtype), head.to(dtype)
    return torch.matmul(rms_norm(x, norm), head)


def prefill(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward (logits only)."""
    return forward(model, tokens)


# --------------------------------------------------------------------- #
# decode path: one token in, KV cache of seq_len
# --------------------------------------------------------------------- #
def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor):
    """tokens [B] (one new token per sequence) → (logits [B, V], cache).

    Updates ``cache`` in place and returns it: each layer's new K and V
    are written at position ``length`` (rows whose ``length`` is at or past
    the cache's end keep their old values, as JAX's dropped write), and
    ``length`` grows by one for every row.  Attention runs through the
    ``gqa_decode`` kernel wrapper, once per layer.
    """
    cfg = model.cfg
    b = tokens.shape[0]
    s_cache = cache["k"].shape[2]
    length = cache["length"]
    # per step, not per layer: the RoPE rows at each row's position
    # (clamped to the table, as JAX's gather) and the flat cache row of
    # the write (clamped; a row at or past the end rewrites its old value)
    pos = length.clamp(max=cfg.max_seq_len - 1)[:, None]    # [B, 1]
    c = model.rope_cos[pos][..., None, :]
    sn = model.rope_sin[pos][..., None, :]
    row = (torch.arange(b, device=length.device) * s_cache
           + length.clamp(max=s_cache - 1))
    dropped = (length >= s_cache)[:, None]
    attend = length + 1
    x = model.embed[tokens][:, None, :]                     # [B, 1, D]
    for li, layer in enumerate(model.layers):
        lp = layer.tensors()
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["attn_norm"]))
        q = rope_rotate(q.reshape(b, 1, -1, cfg.head_dim), c, sn
                        ).reshape(q.shape)
        k = rope_rotate(k, c, sn)
        k_cache, v_cache = cache["k"][li], cache["v"][li]
        for kv, new in ((k_cache, k), (v_cache, v)):
            flat = kv.view(b * s_cache, -1)
            flat.index_copy_(0, row, torch.where(
                dropped, flat.index_select(0, row), new.reshape(b, -1)))
        attn = gqa_kernel.gqa_decode(q[:, 0], k_cache, v_cache, attend)
        x = _mlp(x + torch.matmul(attn.reshape(b, 1, -1), lp["wo"]), lp)
    logits = torch.matmul(rms_norm(x, model.final_norm), model.lm_head)
    length.add_(1)
    return logits[:, 0], cache
