"""The program under test: ``repro_torch``'s transformer and ``LMServer``.

This is the only module of the benchmark that imports the program.  It
builds the port's ``TransformerConfig`` from a configuration file's shape
(refusing a key the port cannot run as stated), builds a ``Transformer``
over the benchmark's weight views, and hands out the entry points the
drivers time: ``LMServer.step`` for decode, ``transformer.prefill``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import LMServer

PORT_EPS = 1e-6          # repro_torch.models.layers.rms_norm's fixed eps


def transformer_config(s, attn_chunk: int = 0) -> T.TransformerConfig:
    """The port's config of model shape ``s``, attention in blocks of
    ``attn_chunk`` positions where a sequence is longer (0: never)."""
    if s.eps != PORT_EPS:
        raise ValueError(f"{s.name}: rms_norm_eps {s.eps} is not the port's "
                         f"fixed {PORT_EPS}")
    moe = None
    if s.moe is not None:
        m = s.moe
        moe = T.MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                          d_expert_ff=m.d_expert,
                          n_shared=1 if m.d_shared else 0,
                          d_shared_ff=m.d_shared,
                          capacity_factor=m.capacity_factor,
                          router_norm_topk=m.norm_topk)
    return T.TransformerConfig(
        name=s.name, n_layers=s.n_layers, d_model=s.d_model,
        n_heads=s.n_heads, n_kv_heads=s.n_kv_heads, d_ff=s.d_ff,
        vocab=s.vocab, head_dim=s.head_dim, qkv_bias=s.qkv_bias,
        rope_theta=s.rope_theta, max_seq_len=s.max_positions, moe=moe,
        dtype=s.dtype, remat=False, attn_chunk_q=attn_chunk,
        attn_chunk_kv=attn_chunk)


def build_model(s, weights: dict, device, attn_chunk: int = 0
                ) -> T.Transformer:
    """A ``Transformer`` whose parameters are the views ``weights`` (no
    second copy is made) and whose RoPE table is the port's own."""
    cfg = transformer_config(s, attn_chunk)
    model = T.Transformer(cfg, device="meta")

    def put(mod: nn.Module, name: str, t: torch.Tensor):
        mod._parameters[name] = nn.Parameter(t, requires_grad=False)
    put(model, "embed", weights["embed"])
    put(model, "final_norm", weights["final_norm"])
    put(model, "lm_head", weights["lm_head"])
    for i, layer in enumerate(model.layers):
        for name in list(layer._parameters):
            put(layer, name, weights[f"layers.{i}.{name}"])
    cos, sin = L.rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                  cfg.rope_theta, device)
    model.register_buffer("rope_cos", cos, persistent=False)
    model.register_buffer("rope_sin", sin, persistent=False)
    return model


def decode_server(model: T.Transformer, slots: int, positions: int,
                  device) -> LMServer:
    """An ``LMServer`` of ``slots`` against a ``positions`` cache, the
    cache made by the port (``init_cache``)."""
    server = LMServer(model, max_slots=slots, max_len=positions,
                      device=device)
    server.cache = T.init_cache(model.cfg, slots, positions, device)
    return server


def prefill(model: T.Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return T.prefill(model, tokens)

