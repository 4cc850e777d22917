"""The port's flash-decoding GQA attention against the reference package's.

On the CPU the wrapper takes its plain version.  Both must agree with the
JAX Pallas kernel, run as the reference's tests run it (interpret mode,
``block_size=128``), at the shapes of ``tests/test_kernels.py``'s sweep
with its tolerances (2e-5 in float32; 2e-2 in bfloat16, whose outputs
round to 8 bits), and with ``gqa_decode_ref`` and
``layers.decode_gqa_attention`` wherever those define the same function
(length ≥ 1).  At length 0 the port follows the Pallas kernel (zeros).
Also: the wrapper's refusals and its launch counter on the CPU.

bfloat16 inputs are made by rounding the same float32 numpy arrays to
nearest-even in each framework, which gives the same bits.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gqa_decode.kernel import gqa_decode_pallas
from repro.kernels.gqa_decode.ref import gqa_decode_ref as jax_ref
from repro.models.layers import decode_gqa_attention
from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
from repro_torch.kernels.gqa_decode import kernel as gqa_kernel

BLOCK = 128
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [(2, 2, 4, 64, 256), (1, 4, 1, 128, 512), (2, 1, 8, 128, 300),
         (4, 2, 2, 64, 1024)]


def _inputs(seed, b, hkv, g, d, s):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv, g, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jx = [jnp.asarray(a, jdt) for a in arrays]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _pallas(jx, length):
    return gqa_decode_pallas(*jx, jnp.asarray(length, jnp.int32),
                             block_size=BLOCK, interpret=True)


def _port(tx, length):
    length = torch.from_numpy(np.asarray(length, np.int32))
    return gqa_decode_ref(*tx, length), gqa_decode(*tx, length)


@pytest.mark.parametrize("b,hkv,g,d,s", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sweep_matches_pallas_and_refs(b, hkv, g, d, s, dtype):
    """The sweep of the reference's kernel test, lengths drawn in [1, S]."""
    rng = np.random.default_rng(b * 100 + s)
    arrays = _inputs(b * 100 + s, b, hkv, g, d, s)
    length = rng.integers(1, s + 1, size=b).astype(np.int32)
    jx, tx = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    plain, wrapped = _port(tx, length)
    assert plain.dtype == wrapped.dtype == tx[0].dtype
    assert torch.equal(plain, wrapped)
    want = _pallas(jx, length)
    np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol, atol=tol)
    f32 = [jnp.asarray(x, jnp.float32) for x in jx]
    for ref in (jax_ref(*f32, jnp.asarray(length)),
                decode_gqa_attention(*f32, jnp.asarray(length))):
        np.testing.assert_allclose(_f32(plain), _f32(ref), rtol=tol,
                                   atol=tol)


# (name, b, hkv, g, d, s, lengths).  S = 300 is off the 128 tile; G = 5 is
# Qwen2.5-14B's group; D = 8 and 24 are the narrowest and an odd D/8.
EDGES = [
    ("length_0", 2, 2, 5, 16, 256, [0, 7]),
    ("length_0_all", 1, 2, 3, 32, 128, [0]),
    ("length_S", 2, 1, 5, 128, 256, [256, 256]),
    ("length_S_off_tile", 2, 2, 5, 16, 300, [300, 1]),
    ("length_above_S", 2, 2, 5, 64, 256, [257, 10_000]),
    ("one_position", 1, 1, 1, 8, 1, [1]),
    ("odd_d_over_8", 3, 2, 5, 24, 130, [129, 2, 130]),
    ("g5_d128", 2, 8, 5, 128, 384, [383, 200]),
]


@pytest.mark.parametrize("case", EDGES, ids=[c[0] for c in EDGES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_edges_match_pallas(case, dtype):
    name, b, hkv, g, d, s, lengths = case
    arrays = _inputs(len(name) * 7 + s, b, hkv, g, d, s)
    jx, tx = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    plain, wrapped = _port(tx, lengths)
    assert torch.equal(plain, wrapped)
    assert bool(torch.isfinite(plain).all())
    np.testing.assert_allclose(_f32(plain), _f32(_pallas(jx, lengths)),
                               rtol=tol, atol=tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not plain[i].any(), f"{name}: length 0 must give zeros"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_length_above_S_off_tile_is_all_positions(dtype):
    """A length above S means all S positions, as in ``gqa_decode_ref`` and
    ``decode_gqa_attention``.  The Pallas kernel pads S up to its tile
    with zero rows and counts them when length > S, so it is not the
    yardstick here (ROADMAP.md, reference fault (g))."""
    b, hkv, g, d, s = 2, 2, 5, 16, 300
    arrays = _inputs(11, b, hkv, g, d, s)
    lengths = [301, 1000]
    jx, tx = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    plain, _ = _port(tx, lengths)
    all_s, _ = _port(tx, [s, s])
    assert torch.equal(plain, all_s)
    f32 = [jnp.asarray(x, jnp.float32) for x in jx]
    ln = jnp.asarray(lengths, jnp.int32)
    for ref in (jax_ref(*f32, ln), decode_gqa_attention(*f32, ln)):
        np.testing.assert_allclose(_f32(plain), _f32(ref), rtol=tol,
                                   atol=tol)


def test_length_0_differs_between_references():
    """Why the port follows the Pallas kernel at length 0: the two jnp
    references give NaN and the mean of V there."""
    arrays = _inputs(5, 1, 1, 2, 16, 64)
    jx, tx = _both(arrays, "float32")
    ln = jnp.asarray([0], jnp.int32)
    assert np.isnan(np.asarray(jax_ref(*jx, ln))).all()
    mean_v = np.asarray(decode_gqa_attention(*jx, ln))
    np.testing.assert_allclose(mean_v[0, 0, 0], arrays[2][0, :, 0].mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(_pallas(jx, [0])), 0.0)
    plain, _ = _port(tx, [0])
    assert not plain.any()


def _ok_args(dtype=torch.float32, b=2, hkv=2, g=5, d=16, s=32):
    q = torch.zeros(b, hkv, g, d, dtype=dtype)
    k = torch.zeros(b, s, hkv, d, dtype=dtype)
    return q, k, k.clone(), torch.ones(b, dtype=torch.int32)


@pytest.mark.parametrize("what,mutate,exc,match", [
    ("float16", lambda q, k, v, n: (q.half(), k.half(), v.half(), n),
     TypeError, "share one of"),
    ("mixed types", lambda q, k, v, n: (q, k.bfloat16(), v, n),
     TypeError, "share one of"),
    ("length int64", lambda q, k, v, n: (q, k, v, n.long()),
     TypeError, "int32"),
    ("q rank", lambda q, k, v, n: (q[0], k, v, n), ValueError, r"\[B, Hkv"),
    ("k heads", lambda q, k, v, n: (q, k[:, :, :1].contiguous(), v, n),
     ValueError, "k and v must be"),
    ("v shape", lambda q, k, v, n: (q, k, v[:, :16].contiguous(), n),
     ValueError, "k and v must be"),
    ("length shape", lambda q, k, v, n: (q, k, v, n[:1]), ValueError,
     "length must be"),
    ("k not contiguous",
     lambda q, k, v, n: (q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, n), ValueError, "contiguous"),
    ("q not contiguous",
     lambda q, k, v, n: (q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, v, n), ValueError, "contiguous"),
    ("D not a multiple of 8",
     lambda q, k, v, n: (q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous(), n), ValueError, "D must"),
    ("D above 256",
     lambda q, k, v, n: _ok_args(d=264)[:3] + (n,), ValueError, "D must"),
    ("G above 8",
     lambda q, k, v, n: (torch.zeros(2, 2, 9, 16), k, v, n), ValueError,
     "G must"),
    ("S = 0",
     lambda q, k, v, n: (q, k[:, :0], v[:, :0], n), ValueError, "S = 0"),
])
def test_wrapper_refuses(what, mutate, exc, match):
    with pytest.raises(exc, match=match):
        gqa_decode(*mutate(*_ok_args()))


def test_cpu_path_never_counts_a_launch():
    before = gqa_kernel.launches
    gqa_decode(*_ok_args())
    gqa_decode(*_ok_args(torch.bfloat16))
    assert gqa_kernel.launches == before


def test_splits_cover_the_cache_from_shapes_alone():
    for bh, s, sms in [(32, 32768, 132), (8, 524288, 132), (64, 1024, 132),
                       (1, 1, 132), (4, 300, 132), (1024, 32768, 132)]:
        n, chunk = gqa_kernel.splits(bh, s, sms)
        assert n >= 1 and chunk >= 1
        assert (n - 1) * chunk < s <= n * chunk      # no empty split
        if n > 1:
            assert chunk >= gqa_kernel.MIN_SPLIT


def test_decode_sweep_reads_ptxas_and_sums_up():
    """``launch.decode_sweep``'s pieces that need no card: the ptxas lines
    of one function, and the summary of a sweep's rows."""
    from repro_torch.launch import decode_sweep as ds
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1fI13__nv_bfloat16Li4EE'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 147 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z1fI13__nv_bfloat16Li5EE'",
        "    8 bytes stack frame, 4 bytes spill stores, 32 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert ds.ptxas_lines(log, "bfloat16Li5E") == (
        "8 bytes stack frame, 4 bytes spill stores, 32 bytes spill loads; "
        "Used 168 registers, used 1 barriers")
    rows = [dict(shape=list(shape), u=u, blocks_per_sm=bps, rep=rep,
                 ms=1.0 + u / 10 + rep / 100 - (u == 8) * bps / 1000)
            for shape in ds.SHAPES for rep in range(2)
            for u in ds.ROWS_IN_FLIGHT for bps in ds.BLOCKS_PER_SM]
    assert ds.DEFAULT == (2, gqa_kernel.BLOCKS_PER_SM)   # as built
    got = ds.summary(rows)["4x32768"]
    assert got["default_ms"] == pytest.approx([1.2, 1.21])
    assert got["best"] == dict(u=1, blocks_per_sm=2, rep=0, ms=1.1)
    assert got["best_setting_ms"] == [1.1, 1.11]


def test_decode_sweep_needs_a_card():
    from repro_torch.launch import decode_sweep as ds
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ds.sweep(reps=1)
