"""Operations and bytes of the benchmark's steps and kernels, from the
configuration's shapes alone.

Model FLOPs count what the model's function needs, whatever computes it:
each product once, 2 operations a multiply-add; causal attention as half
of S^2 (q.k and p.v over each query's own prefix); a routed token's top-k
experts only (no capacity slot, padding, recomputation or skipped chunk
counts).  Bytes count each input read once and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak_flops(dtype: str) -> float:
    return PEAKS["bf16_flops_per_s" if dtype == "bfloat16"
                 else "fp32_flops_per_s"]


def bandwidth() -> float:
    return PEAKS["hbm_bytes_per_s"]


def attn_proj_params(s) -> int:
    """q, k, v and output projections of one layer."""
    return s.d_model * s.head_dim * (2 * s.n_heads + 2 * s.n_kv_heads)


def mlp_active_params(s) -> int:
    """The MLP weights one token multiplies by in one layer: the dense
    MLP, or the router, its top-k experts, the shared expert and its gate."""
    d = s.d_model
    m = s.moe
    if m is None:
        return 3 * d * s.d_ff
    shared = 3 * d * m.d_shared + d if m.d_shared else 0
    return d * m.n_experts + m.top_k * 3 * d * m.d_expert + shared


def weight_params(s) -> int:
    """Every weight but the embedding (norms and biases included)."""
    d, hd = s.d_model, s.head_dim
    per = attn_proj_params(s) + 2 * d
    if s.qkv_bias:
        per += hd * (s.n_heads + 2 * s.n_kv_heads)
    m = s.moe
    if m is None:
        per += 3 * d * s.d_ff
    else:
        per += d * m.n_experts + m.n_experts * 3 * d * m.d_expert
        if m.d_shared:
            per += 3 * d * m.d_shared + d
    return s.n_layers * per + d + d * s.vocab


def prefill_flops(s, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill call: ``batch`` prompts of ``seq``
    tokens, logits at every position."""
    tokens = batch * seq
    linear = 2.0 * tokens * (s.n_layers * (attn_proj_params(s)
                                           + mlp_active_params(s))
                             + s.d_model * s.vocab)
    attn = 2.0 * batch * s.n_layers * s.n_heads * s.head_dim * seq * seq
    return linear + attn


def decode_step_flops(s, attend) -> float:
    """Model FLOPs of one dense decode step of len(attend) sequences, the
    b-th attending to attend[b] positions."""
    b = len(attend)
    linear = 2.0 * b * (s.n_layers * (attn_proj_params(s)
                                      + mlp_active_params(s))
                        + s.d_model * s.vocab)
    return linear + 4.0 * s.n_layers * s.n_heads * s.head_dim * float(
        np.sum(attend))


def decode_step_bytes(s, attend) -> float:
    """Bytes of one dense decode step: every weight but the embedding
    once, the B embedding rows, each layer's K and V rows up to each
    sequence's attend (the new row included), the new K and V rows
    written, q read by attention, and the logits written."""
    if s.moe is not None:
        raise NotImplementedError("a decode step's expert bytes depend "
                                  "on its routing")
    b, e = len(attend), s.elt
    kv_row = s.n_kv_heads * s.head_dim * e
    per_layer = (2 * kv_row * float(np.sum(attend)) + 2 * kv_row * b
                 + b * s.n_heads * s.head_dim * e)
    return (weight_params(s) * e + b * s.d_model * e
            + s.n_layers * per_layer + b * s.vocab * e)


def step_bound_s(s, flops: float, nbytes: float) -> float:
    """Least time of a step on the chip: the larger of its FLOPs over the
    dtype's peak and its bytes over the memory's rate."""
    return max(flops / peak_flops(s.dtype), nbytes / bandwidth())


def gqa_decode_bytes(s, attend) -> float:
    """One launch of gqa_decode: q, the K and V rows up to each
    sequence's attend, the output."""
    b, e = len(attend), s.elt
    q = b * s.n_heads * s.head_dim * e
    return 2 * q + 2 * s.n_kv_heads * s.head_dim * e * float(np.sum(attend))
