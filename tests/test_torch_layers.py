"""The port's model layers against ``repro.models.layers``, in float32.

The same numpy inputs go through both.  Tolerances: the RoPE table is
bit-equal by construction (one float64 numpy table, rounded once); the
elementwise layers agree to 1e-6 (the frameworks round the same float32
operations, up to fused or reordered arithmetic); products and softmaxes
to rtol/atol 2e-5, the reference's own float32 kernel tolerance
(``tests/test_kernels.py``), since the two sum in different orders.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 5, 4, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = TL.rms_norm(_t(x), _t(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("head_dim,max_len,theta", [(16, 256, 1e6),
                                                    (128, 4096, 1e4)])
def test_rope_frequencies_bit_equal(head_dim, max_len, theta):
    jc, js = JL.rope_frequencies(head_dim, max_len, theta)
    tc, ts = TL.rope_frequencies(head_dim, max_len, theta)
    assert tc.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


def test_apply_rope_prefix():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jc, js = JL.rope_frequencies(16, 32, 1e6)
    tc, ts = TL.rope_frequencies(16, 32, 1e6)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    got = TL.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_apply_rope_positions_clamp_past_table():
    """Positions at or past the table's end take its last row in both
    (JAX clamps the gather; torch would raise without the clamp)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[5], [7], [40]], np.int32)     # table has 8 rows
    jc, js = JL.rope_frequencies(16, 8, 1e4)
    tc, ts = TL.rope_frequencies(16, 8, 1e4)
    want = JL.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    got = TL.apply_rope(_t(x), tc, ts, _t(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    at_end = TL.apply_rope(_t(x), tc, ts, _t(np.array([[7], [7], [7]],
                                                      np.int32)))
    np.testing.assert_array_equal(_np(got)[2], _np(at_end)[2])


def test_swiglu():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    want = JL.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    got = TL.swiglu(*(_t(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,hkv,g,dh", [(2, 9, 2, 2, 16), (1, 16, 1, 5, 32),
                                          (3, 4, 4, 1, 8)])
def test_causal_gqa_attention(b, s, hkv, g, dh):
    rng = np.random.default_rng(b * 10 + s)
    q = rng.standard_normal((b, s, hkv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    want = JL.causal_gqa_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = TL.causal_gqa_attention(_t(q), _t(k), _t(v))
    assert got.shape == (b, s, hkv, g, dh)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lengths", [[1, 13], [0, 20], [20, 25]])
def test_decode_gqa_attention(lengths):
    """Including length 0 (the mean of V in both) and a length above S."""
    rng = np.random.default_rng(sum(lengths))
    b, s, hkv, g, dh = 2, 20, 2, 5, 16
    q = rng.standard_normal((b, hkv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    want = JL.decode_gqa_attention(*(jnp.asarray(a)
                                     for a in (q, k, v, length)))
    got = TL.decode_gqa_attention(_t(q), _t(k), _t(v), _t(length))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
