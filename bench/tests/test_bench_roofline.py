"""The roofline counts against hand counts at a tiny configuration."""

from __future__ import annotations

import math

import numpy as np
import pytest

from harness.weights import MoEShape, ModelShape, leaves
from roofline import counts

DENSE = ModelShape(name="t", n_layers=2, d_model=8, n_heads=4, n_kv_heads=2,
                   head_dim=2, d_ff=16, vocab=10, rope_theta=1e4,
                   max_positions=64, eps=1e-6, qkv_bias=False,
                   dtype="bfloat16")
MOE = ModelShape(name="m", n_layers=2, d_model=8, n_heads=4, n_kv_heads=4,
                 head_dim=2, d_ff=16, vocab=10, rope_theta=1e4,
                 max_positions=64, eps=1e-6, qkv_bias=True, dtype="bfloat16",
                 moe=MoEShape(n_experts=6, top_k=2, d_expert=4, d_shared=12,
                              norm_topk=False, capacity_factor=1.25))


def test_prefill_flops_dense_by_hand():
    # per token per layer: q 8x8, k 8x4, v 8x4, o 8x8 -> 192 weights;
    # MLP 3 x 8 x 16 = 384; head 8 x 10 = 80
    b, s = 3, 5
    linear = 2 * b * s * (2 * (192 + 384) + 80)
    attn = 2 * b * 2 * 4 * 2 * s * s     # q.k and p.v over half of S^2
    assert counts.prefill_flops(DENSE, b, s) == linear + attn


def test_prefill_flops_moe_counts_top_k_only():
    # per token per layer: attention 8 x (8 + 8 + 8 + 8) = 256; router
    # 8 x 6; 2 experts of 3 x 8 x 4; shared 3 x 8 x 12 and its gate 8
    per = 256 + 48 + 2 * 96 + 288 + 8
    assert counts.prefill_flops(MOE, 1, 1) == 2 * (2 * per + 80) + 2 * 2 * 4 * 2


def test_weight_params_is_every_weight_but_the_embedding():
    for s in (DENSE, MOE):
        every = sum(math.prod(shape) for _, shape in leaves(s))
        assert counts.weight_params(s) == every - s.vocab * s.d_model


def test_decode_step_bytes_by_hand():
    attend = np.array([3, 5])
    e = 2
    kv_row = 2 * 2 * e                    # Hkv x hd x bytes
    per_layer = 2 * kv_row * 8 + 2 * kv_row * 2 + 2 * 4 * 2 * e
    want = (counts.weight_params(DENSE) * e + 2 * 8 * e + 2 * per_layer
            + 2 * 10 * e)
    assert counts.decode_step_bytes(DENSE, attend) == want
    with pytest.raises(NotImplementedError):
        counts.decode_step_bytes(MOE, attend)


def test_decode_step_flops_by_hand():
    attend = np.array([3, 5])
    linear = 2 * 2 * (2 * (192 + 384) + 80)
    assert counts.decode_step_flops(DENSE, attend) == linear + 4 * 2 * 4 * 2 * 8


def test_gqa_decode_bytes_by_hand():
    attend = np.array([3, 5])
    q = 2 * 4 * 2 * 2
    assert counts.gqa_decode_bytes(DENSE, attend) == 2 * q + 2 * 2 * 2 * 2 * 8


def test_bound_takes_the_larger_side():
    s = DENSE
    assert counts.step_bound_s(s, 989e12, 0) == pytest.approx(1.0)
    assert counts.step_bound_s(s, 0, 3.35e12) == pytest.approx(1.0)
