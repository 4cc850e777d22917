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
import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's card script)

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
    # G above 8: the mma kernel's 16-row instance (Qwen3-MoE-235B's G = 16)
    ("g9_d64_off_tile", 2, 2, 9, 64, 300, [300, 129]),
    ("g12_d128_length_0", 2, 1, 12, 128, 256, [0, 255]),
    ("g16_d128", 2, 4, 16, 128, 384, [384, 17]),
    ("g16_d16_above_S", 2, 1, 16, 16, 256, [257, 5]),
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
    ("G = 0",
     lambda q, k, v, n: (q[:, :, :0].contiguous(), k, v, n), ValueError,
     "at least 1"),
    ("D = 0",
     lambda q, k, v, n: (q[..., :0].contiguous(), k[..., :0].contiguous(),
                         v[..., :0].contiguous(), n), ValueError,
     "at least 1"),
    ("S = 0",
     lambda q, k, v, n: (q, k[:, :0], v[:, :0], n), ValueError, "S = 0"),
])
def test_wrapper_refuses(what, mutate, exc, match):
    with pytest.raises(exc, match=match):
        gqa_decode(*mutate(*_ok_args()))


@pytest.mark.parametrize("what,mutate", [
    ("D not a multiple of 8",
     lambda q, k, v, n: (q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous(), n)),
    ("D above 256", lambda q, k, v, n: _ok_args(d=264)[:3] + (n,)),
    ("G above 16",
     lambda q, k, v, n: (torch.zeros(2, 2, 17, 16), k, v, n)),
])
def test_wrapper_takes_any_g_and_d_on_the_cpu(what, mutate):
    """Fault (w): the shapes the wrapper refused before take the plain
    version on the CPU, as the reference takes them; the operator's fake
    implementation and FLOP formula take them too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    args = mutate(*_ok_args())
    out = gqa_decode(*args)
    assert out.shape == args[0].shape
    assert torch.equal(out, gqa_decode_ref(*args))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fakes = [mode.from_tensor(x) for x in args]
        counter = FlopCounterMode(display=False)
        with counter:
            got = gqa_decode(*fakes)
    assert got.shape == args[0].shape
    b, hkv, g, d = args[0].shape
    assert counter.get_total_flops() == 4 * b * hkv * g * args[1].shape[1] * d


# Fault (w): G above one m16 tile and D off a multiple of 8 or above 256,
# against the Pallas kernel in interpret mode (which takes any G and D).
WIDE = [("g17", 2, 2, 17, 64, 300, [300, 129]),
        ("g24_d128", 2, 2, 24, 128, 256, [256, 0]),
        ("g40_d64_above_S", 1, 3, 40, 64, 256, [10_000]),
        ("d12", 2, 2, 5, 12, 260, [260, 3]),
        ("d36_g24", 2, 1, 24, 36, 300, [7, 300]),
        ("d100_g17", 1, 2, 17, 100, 257, [257]),
        ("d320_g40", 2, 1, 40, 320, 130, [130, 64])]


@pytest.mark.parametrize("case", WIDE, ids=[c[0] for c in WIDE])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_any_g_and_d_match_pallas(case, dtype):
    name, b, hkv, g, d, s, lengths = case
    arrays = _inputs(len(name) * 11 + s, b, hkv, g, d, s)
    jx, tx = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    plain, wrapped = _port(tx, lengths)
    assert torch.equal(plain, wrapped) and plain.shape == (b, hkv, g, d)
    np.testing.assert_allclose(_f32(plain), _f32(_pallas(jx, lengths)),
                               rtol=tol, atol=tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not plain[i].any()


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
    def ms(tile, stages, bps, rep):
        return 1.0 + stages / 10 + rep / 100 - (tile == 128) * bps / 1000

    rows = [dict(shape=list(shape), tile=t, stages=st, blocks_per_sm=bps,
                 rep=rep, ms=ms(t, st, bps, rep))
            for shape in ds.SHAPES for rep in range(2)
            for t, st in ds.VARIANTS for bps in ds.BLOCKS_PER_SM]
    rows += [dict(shape=list(shape), rep=rep, fma_ms=2.0 + rep,
                  sdpa_ms=0.5 + rep) for shape in ds.SHAPES
             for rep in range(2)]
    assert ds.DEFAULT == (gqa_kernel.TILE, gqa_kernel.STAGES,
                          gqa_kernel.BLOCKS_PER_SM)   # as built
    got = ds.summary(rows)["4x32768"]
    assert got["default_ms"] == pytest.approx(
        [ms(*ds.DEFAULT, rep) for rep in range(2)])
    assert got["fma_ms"] == [2.0, 3.0] and got["sdpa_ms"] == [0.5, 1.5]
    top = max(ds.BLOCKS_PER_SM)
    assert got["best"] == dict(tile=128, stages=2, blocks_per_sm=top, rep=0,
                               ms=pytest.approx(ms(128, 2, top, 0)))
    assert got["best_setting_ms"] == pytest.approx(
        [ms(128, 2, top, rep) for rep in range(2)])


def test_decode_sweep_needs_a_card():
    from repro_torch.launch import decode_sweep as ds
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ds.sweep(reps=1)


# ------------------------------------------------------------------ #
# The mma path's arithmetic (bfloat16, D <= 128), emulated in torch
# ------------------------------------------------------------------ #
H100_SMS = 132


def emulate_mma(q, k, v, length, sms=H100_SMS, tile=None,
                single_bf16=False):
    """The mma kernel's arithmetic in its order, in torch on the CPU.

    Splits as the wrapper cuts them; each split walks tiles of ``tile``
    positions, and each warp of a block owns 16 positions of a tile with
    its own online softmax in float32 (scores of bfloat16 q and K summed
    in float32, scaled by 1/√D; positions at or past the split's end or
    min(length, S) at -inf).  P·V takes P_hi = bf16(p) and P_lo =
    bf16(p - P_hi) (``single_bf16``: P_hi alone): at G ≤ 8 (the kernel's
    8-row instance, P_lo in rows 8-15) into two float32 sums added when
    the warps merge at the block's max; at G > 8 (the 16-row instance, two
    products a V fragment) P_hi·V and then P_lo·V into one float32 sum.
    The combine merges the splits with l > 0 and rounds to bfloat16.
    Above G = 16 the rows go in tiles of 16 on the grid, each the 16-row
    instance: rows stay independent, and only the splits change (cut for
    B·Hkv·tiles blocks)."""
    tile = tile or gqa_kernel.TILE
    b, hkv, g, d = q.shape
    s = k.shape[1]
    n_split, chunk = gqa_kernel.splits(b * hkv * gqa_kernel.row_tiles(g), s,
                                       sms, gqa_kernel.MMA, tile)
    assert chunk % tile == 0
    one_sum = gqa_kernel.mma_rows(g) == 16
    warps = tile // 16
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    qf = q.float()                                        # [B, H, G, D]
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # [B, H, S, D]
    ln = length.long().clamp(0, s)
    lo = torch.arange(n_split) * chunk                    # [N]
    hi = torch.minimum(lo[None] + chunk, ln[:, None])     # [B, N]
    shape = (b, hkv, n_split, warps, g)
    m = torch.full(shape, -1e30)
    l = torch.zeros(shape)
    o_hi, o_lo = torch.zeros(shape + (d,)), torch.zeros(shape + (d,))
    lane = torch.arange(16)
    bi = torch.arange(b)[:, None, None, None, None]
    hi_ = torch.arange(hkv)[None, :, None, None, None]
    for t in range(chunk // tile):
        first = lo[:, None] + t * tile + 16 * torch.arange(warps)  # [N, W]
        pos = first[..., None] + lane                              # [N, W, 16]
        end = hi[:, None, :, None, None]                 # [B, 1, N, 1, 1]
        valid = pos[None, None] < end                    # [B, 1, N, W, 16]
        active = (first[None, None] < hi[:, None, :, None])[..., None]
        at = pos.clamp(max=s - 1)[None, None]
        kk, vv = kf[bi, hi_, at], vf[bi, hi_, at]         # [B, H, N, W, 16, D]
        sc = torch.einsum("bhgd,bhnwpd->bhnwgp", qf, kk) * scale
        sc = torch.where(valid[:, :, :, :, None], sc, -torch.inf)
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(sc - mx[..., None])
        vv = torch.where(valid[..., None], vv, 0.0)
        p_hi = p.bfloat16().float()
        p_lo = torch.zeros_like(p) if single_bf16 else \
            (p - p_hi).bfloat16().float()
        l = torch.where(active, l * alpha + p.sum(-1), l)
        hi_v = torch.einsum("bhnwgp,bhnwpd->bhnwgd", p_hi, vv)
        lo_v = torch.einsum("bhnwgp,bhnwpd->bhnwgd", p_lo, vv)
        if one_sum:
            o_hi = torch.where(active[..., None], o_hi * alpha[..., None]
                               + hi_v + lo_v, o_hi)
        else:
            o_hi = torch.where(active[..., None], o_hi * alpha[..., None]
                               + hi_v, o_hi)
            o_lo = torch.where(active[..., None], o_lo * alpha[..., None]
                               + lo_v, o_lo)
        m = torch.where(active, mx, m)
    # the warps merge at the block's max
    mstar = m.amax(3, keepdim=True)
    wgt = torch.exp(m - mstar)
    acc = ((o_hi + o_lo) * wgt[..., None]).sum(3)         # [B, H, N, G, D]
    lsum = (l * wgt).sum(3)                               # [B, H, N, G]
    mpart = mstar[:, :, :, 0]
    # the combine: splits with l > 0
    used = lsum > 0
    mall = torch.where(used, mpart, -1e30).amax(2, keepdim=True)
    w = torch.where(used, torch.exp(mpart - mall), 0.0)
    total = (lsum * w).sum(2)
    out = (acc * w[..., None]).sum(2) / total.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("case", [("sweep",) + c + (None,) for c in SWEEP]
                         + EDGES, ids=lambda c: c[0] + str(list(c[1:6])))
def test_mma_emulation_matches_pallas(case):
    """The mma path's arithmetic against the Pallas kernel (interpret
    mode) at the bfloat16 tolerance of the kernel tests."""
    name, b, hkv, g, d, s, lengths = case
    seed = b * 100 + s if lengths is None else len(name) * 7 + s
    arrays = _inputs(seed, b, hkv, g, d, s)
    if lengths is None:
        lengths = np.random.default_rng(seed).integers(1, s + 1, size=b)
    jx, tx = _both(arrays, "bfloat16")
    tol = DTYPES["bfloat16"][2]
    got = emulate_mma(*tx, torch.tensor(np.asarray(lengths, np.int32)))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_f32(got), _f32(_pallas(jx, lengths)),
                               rtol=tol, atol=tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any(), f"{name}: length 0 must give zeros"


def _deploy_inputs(seed=0, s=32_768, g=5, d=128):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((1, 1, g, d), (1, s, 1, d), (1, s, 1, d)))
    return q, k, v, torch.tensor([s], dtype=torch.int32)


@pytest.mark.parametrize("single_bf16", [False, True],
                         ids=["p_hi_plus_lo", "p_single_bf16"])
def test_mma_emulation_at_32k_deploy_tolerance(single_bf16):
    """At [1, 32768, 1, 128], G = 5, the split P holds chip_smoke.py's
    deployment tolerance against the plain version; P rounded once to
    bfloat16 must fail it (that is why the kernel splits P)."""
    args = _deploy_inputs()
    got = emulate_mma(*args, single_bf16=single_bf16)
    want = gqa_decode_ref(*args)
    assert chip_smoke.deploy_close(got, want) is not single_bf16


@pytest.mark.parametrize("single_bf16", [False, True],
                         ids=["p_hi_plus_lo", "p_single_bf16"])
def test_mma_emulation_at_g16_deploy_tolerance(single_bf16):
    """The same at Qwen3-MoE-235B's G = 16 (the 16-row instance: P_hi·V
    and P_lo·V into one sum): the split P holds the deployment tolerance,
    P rounded once to bfloat16 fails it."""
    args = _deploy_inputs(seed=1, g=16)
    got = emulate_mma(*args, single_bf16=single_bf16)
    want = gqa_decode_ref(*args)
    assert chip_smoke.deploy_close(got, want) is not single_bf16


@pytest.mark.parametrize("g", [9, 16, 17, 24, 40])
def test_mma_emulation_g_above_8_matches_ref_and_pallas(g):
    """The 16-row instance's arithmetic against ``gqa_decode_ref`` and
    the Pallas kernel in interpret mode, at lengths over several splits
    and tiles (Qwen3-MoE-235B's layout: Hkv = 4, D = 128)."""
    b, hkv, d, s = 2, 4, 128, 2048
    arrays = _inputs(31 + g, b, hkv, g, d, s)
    lengths = [2048, 1001]
    jx, tx = _both(arrays, "bfloat16")
    length = torch.tensor(lengths, dtype=torch.int32)
    got = emulate_mma(*tx, length)
    tol = DTYPES["bfloat16"][2]
    np.testing.assert_allclose(_f32(got), _f32(gqa_decode_ref(*tx, length)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(_pallas(jx, lengths)),
                               rtol=tol, atol=tol)
    assert chip_smoke.deploy_close(got, gqa_decode_ref(*tx, length))


def test_path_rule_is_dtype_and_d():
    rule = gqa_kernel.path
    assert [rule(torch.bfloat16, d) for d in (8, 16, 24, 64, 128)] \
        == [gqa_kernel.MMA] * 5
    assert rule(torch.bfloat16, 136) == rule(torch.bfloat16, 256) \
        == gqa_kernel.FMA
    assert [rule(torch.float32, d) for d in (8, 128, 256)] \
        == [gqa_kernel.FMA] * 3


@pytest.mark.parametrize("tile", [64, 128])
def test_mma_splits_cover_whole_tiles_in_one_wave(tile):
    for bh, s, sms in [(32, 32768, 132), (8, 524288, 132), (64, 1024, 132),
                       (1, 1, 132), (4, 300, 132), (1024, 256, 132),
                       (1, 2048, 132), (2, 40, 132), (48, 100_000, 114)]:
        n, chunk = gqa_kernel.splits(bh, s, sms, gqa_kernel.MMA, tile)
        assert chunk % tile == 0
        assert (n - 1) * chunk < s <= n * chunk      # covered, none empty
        assert n == 1 or (bh * n <= gqa_kernel.BLOCKS_PER_SM * sms
                          and chunk >= gqa_kernel.MIN_SPLIT)
        assert gqa_kernel.splits(bh, s, sms, gqa_kernel.MMA, tile) \
            == (n, chunk)                            # shapes alone
    n = 4 * gqa_kernel.BLOCKS_PER_SM      # 32 pairs on 132 SMs
    assert gqa_kernel.splits(32, 32768, 132, gqa_kernel.MMA, 64) \
        == (n, 32768 // n)


def test_mma_shared_memory_fits_every_setting():
    """Every D the mma path takes, at the built setting and every setting
    that launch.decode_sweep builds, fits a block's 227 KB."""
    from repro_torch.launch import decode_sweep as ds
    settings = {(gqa_kernel.TILE, gqa_kernel.STAGES)} | set(ds.VARIANTS)
    for tile, stages in settings:
        for d in range(8, gqa_kernel.MMA_MAX_D + 1, 8):
            for g in (1, 8, 9, gqa_kernel.MMA_ROWS, 40):
                assert gqa_kernel.mma_smem_bytes(d, tile, stages, g) \
                    <= gqa_kernel.SMEM_LIMIT, (tile, stages, d, g)
    assert gqa_kernel.mma_smem_bytes(128, 64, 3) == 3 * 2 * 64 * 136 * 2 \
        + 8 * 3 + 2 * 4 * 8 * 4
    assert gqa_kernel.mma_smem_bytes(128, 64, 3, g=16) \
        == gqa_kernel.mma_smem_bytes(128, 64, 3) + 2 * 4 * 8 * 4


def test_wrapper_settings_are_the_sources():
    """kernel.TILE and kernel.STAGES name what csrc/gqa_decode.cu builds."""
    from repro_torch.launch import decode_sweep as ds
    assert ds.DEFAULT[:2] == (gqa_kernel.TILE, gqa_kernel.STAGES)
