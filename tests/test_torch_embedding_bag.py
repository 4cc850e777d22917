"""The port's EmbeddingBag (plain version, wrapper on the CPU, ops) against
``repro.kernels.embedding_bag`` and ``repro.models.recsys._embed_bag``.

The reference's Pallas path cannot run (``pl.load`` is gone from jax 0.9,
ROADMAP.md §3 fault (a)), so the port is held against its two working
definitions, ``embedding_bag_padded(use_pallas=False)`` (take + einsum)
and ``embedding_bag_ref`` (segment sum), and the models' ``_embed_bag``.
In float32 all of them add a bag's rows in bag order, so they and the
port's in-order float32 sum agree bit for bit: the tolerance is 0.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro.kernels.embedding_bag import ops as jax_ops  # noqa: E402
from repro.kernels.embedding_bag import ref as jax_ref  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag, embedding_bag_padded, embedding_bag_padded_ref,
    embedding_bag_ref, kernel, pad_ragged, take)

SWEEP = [(100, 32, 8, 5), (1000, 64, 16, 20), (64, 128, 4, 3)]


def _case(v, d, b, l, seed=None):
    """The reference kernel test's inputs (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(v + d if seed is None else seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    w = (rng.random((b, l)) < 0.8).astype(np.float32)
    return table, idx, w


def _bits(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.mark.parametrize("v,d,b,l", SWEEP)
def test_padded_bitwise_equals_every_reference_definition(v, d, b, l):
    table, idx, w = _case(v, d, b, l)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(w)).numpy()
    seg = np.repeat(np.arange(b), l)
    wants = {
        "padded jnp": jax_ops.embedding_bag_padded(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)),
        "segment ref": jax_ref.embedding_bag_ref(
            jnp.asarray(table), jnp.asarray(idx.reshape(-1)),
            jnp.asarray(seg), b, weights=jnp.asarray(w.reshape(-1))),
        "recsys._embed_bag": JR._embed_bag(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)),
    }
    for what, want in wants.items():
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_ref_matches_jax(combiner, weighted):
    """Ragged segments (some empty, the last bag empty too) with both
    combiners: bit for bit."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((60, 12)).astype(np.float32)
    idx = rng.integers(0, 60, size=40).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 2, 4, 5, 7], size=40)).astype(np.int32)
    w = rng.random(40).astype(np.float32) if weighted else None
    want = jax_ref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 9,
        weights=None if w is None else jnp.asarray(w), combiner=combiner)
    got = embedding_bag_ref(
        torch.from_numpy(table), torch.from_numpy(idx),
        torch.from_numpy(seg), 9,
        weights=None if w is None else torch.from_numpy(w),
        combiner=combiner)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not got[[3, 6, 8]].any()


def test_take_follows_jnp_take():
    """[-V, 0) wraps; outside [-V, V) gives a NaN row."""
    v = 5
    table = np.arange(v * 3, dtype=np.float32).reshape(v, 3)
    ids = np.array([[0, 4, -1, -5], [-6, 5, 2 ** 31 - 1, -2 ** 31]],
                   np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = take(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 4, 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()


def test_nan_rows_stay_nan_at_weight_zero():
    table, idx, w = _case(30, 8, 6, 4, seed=3)
    idx[0, 1], idx[2, 3], idx[4, 0] = 30, -31, -2          # bad, bad, wrap
    w[0, 1] = w[2, 3] = 0.0
    want = jax_ops.embedding_bag_padded(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.asarray(w))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(got[[0, 2]]).all() and not np.isnan(got[[1, 3, 4, 5]]).any()


@pytest.mark.parametrize("b,l", [(0, 5), (6, 0), (0, 0)])
def test_empty_batch_and_empty_bags(b, l):
    table, idx, w = _case(20, 8, b, l, seed=1)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(w))
    want = np.asarray(jax_ops.embedding_bag_padded(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)))
    assert got.shape == want.shape == (b, 8)
    assert got.dtype == torch.float32 and not got.any()


@pytest.mark.parametrize("d", [1, 10, 64])
def test_bfloat16_table_within_one_ulp_of_jax(d):
    """A bfloat16 table: the port adds in float32 and rounds once (the
    Pallas body); the reference's jnp path multiplies and sums in
    bfloat16.  They may differ by one bfloat16 ulp of the output."""
    table, idx, w = _case(200, d, 16, 8, seed=d)
    jt = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jax_ops.embedding_bag_padded(
        jt, jnp.asarray(idx), jnp.asarray(w))).astype(np.float32)
    tt = torch.from_numpy(table).bfloat16()
    got = embedding_bag(tt, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    # the table's bits are the same on both sides
    np.testing.assert_array_equal(
        tt.float().numpy(), np.asarray(jt).astype(np.float32))
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    # and it is the float32 sum of the widened rows, rounded once
    wide = embedding_bag(tt.float(), torch.from_numpy(idx),
                         torch.from_numpy(w)).bfloat16().float().numpy()
    np.testing.assert_array_equal(got, wide)


def test_pad_ragged_equals_reference():
    rng = np.random.default_rng(2)
    sizes = [3, 0, 7, 1, 12, 4]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    ids = rng.integers(0, 100, size=offsets[-1]).astype(np.int32)
    for max_bag in (4, 8, 12):        # truncates the longer bags silently
        got = pad_ragged(ids, offsets, max_bag)
        want = jax_ops.pad_ragged(ids, offsets, max_bag)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_float64_table_on_the_host():
    """The CPU oracle of the tests and of ``chip_smoke.py`` runs the models
    in float64: the plain version then sums in float64."""
    table, idx, w = _case(50, 6, 5, 4, seed=9)
    got = embedding_bag(torch.from_numpy(table).double(),
                        torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float64
    want = (table.astype(np.float64)[idx] * w[..., None]).sum(1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-15)


def test_wrapper_checks_and_counts_no_launch_on_the_cpu():
    table, idx, w = (torch.from_numpy(a) for a in _case(20, 8, 4, 3))
    before = kernel.launches
    embedding_bag(table, idx, w)
    assert kernel.launches == before
    with pytest.raises(TypeError, match="int32"):
        embedding_bag(table, idx.long(), w)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(table, idx, w.double())
    with pytest.raises(TypeError, match="table"):
        embedding_bag(table.half(), idx, w)
    with pytest.raises(ValueError, match="shape"):
        embedding_bag(table, idx, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="no rows"):
        embedding_bag(table[:0], idx, w)
    with pytest.raises(ValueError, match=r"\[V, D\]"):
        embedding_bag(table[0], idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table, idx.t().contiguous().t(), w.t().contiguous().t())
    with pytest.raises(ValueError, match="no kernel"):
        embedding_bag(table.to("meta"), idx.to("meta"), w.to("meta"))


def test_ops_casts_as_the_pallas_wrapper():
    """``embedding_bag_padded`` takes int64 ids, float64 weights and
    non-contiguous inputs, as the reference casts them."""
    table, idx, w = (torch.from_numpy(a) for a in _case(40, 8, 6, 5))
    want = embedding_bag(table, idx, w)
    got = embedding_bag_padded(table, idx.long().t().contiguous().t(),
                               w.double())
    assert torch.equal(got, want)
    assert torch.equal(want, embedding_bag_padded_ref(table, idx, w))


def _pallas_body(table, idx, w):
    """The Pallas body's arithmetic (``kernel.py:_bag_kernel``) in JAX,
    outside Pallas (its ``pl.load`` is gone from jax 0.9): acc from zeros,
    ``acc + w · row`` in float32 item by item, rows by ``jnp.take``, cast
    once at the end."""
    acc = jnp.zeros((idx.shape[0], table.shape[1]), jnp.float32)
    for i in range(idx.shape[1]):
        acc = acc + w[:, i, None] * jnp.take(table, idx[:, i],
                                             axis=0).astype(jnp.float32)
    return acc.astype(table.dtype)


@pytest.mark.parametrize("case", chip_smoke.BAG_CASES,
                         ids=[c[0] for c in chip_smoke.BAG_CASES])
def test_chip_smoke_bag_cases_match_jax(case):
    """Every case of ``chip_smoke.py``'s phase 13 against the reference's
    padded jnp path: bit for bit in float32, within one bfloat16 ulp. At
    L = 1 einsum returns w·x itself, -0.0 for a zero weight on a negative
    entry, where the body's 0 + w·x is +0.0: there both sides are compared
    after ``+ 0.0``, and against the Pallas body's arithmetic run in JAX
    bit for bit as they stand."""
    table, idx, w = chip_smoke.bag_case(*case)
    got = embedding_bag(table, idx, w).float().numpy()
    jt = jnp.asarray(table.float().numpy())
    if table.dtype == torch.bfloat16:
        jt = jt.astype(jnp.bfloat16)
    ji, jw = jnp.asarray(idx.numpy()), jnp.asarray(w.numpy())
    want = np.asarray(jax_ops.embedding_bag_padded(jt, ji, jw)
                      ).astype(np.float32)
    if idx.shape[1] == 1:
        body = np.asarray(_pallas_body(jt, ji, jw)).astype(np.float32)
        np.testing.assert_array_equal(_bits(got), _bits(body))
    if table.dtype == torch.float32:
        if idx.shape[1] == 1:
            got, want = got + np.float32(0.0), want + np.float32(0.0)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[ok]),
                                                  1e-30))) - 7)
        assert (np.abs(got[ok] - want[ok]) <= ulp).all()


def _plan_coverage(b, l, d, elt, aligned, sms):
    """How often the launch plan's lanes add each (bag, item, element) and
    store each (bag, element), by the kernel's index arithmetic: warp w
    takes bags [w · run, (w + 1) · run); a step at (b0, i0) gives group g's
    slot (j, i) item i0 + i of bag b0 + j · groups + g; lane ``sub`` of a
    group holds elements base + (c · lanes + sub) · vec of each pass."""
    p = kernel.plan(b, l, d, elt, aligned, sms)
    groups = 32 // p.lanes
    span = p.ch * p.lanes * p.vec
    adds = np.zeros((b, l, d), np.int64)
    stores = np.zeros((b, d), np.int64)
    lanes = [c * p.lanes + sub for c in range(p.ch) for sub in range(p.lanes)]
    for warp in range(p.grid * kernel.WARPS):
        run0 = warp * p.bags_per_warp
        if run0 >= b:
            break
        run1 = min(run0 + p.bags_per_warp, b)
        for base in range(0, d, span):
            b0, i0 = run0, 0
            while b0 < run1:
                last = i0 + p.items >= l
                for g in range(groups):
                    for j in range(p.bags):
                        bag = b0 + j * groups + g
                        if bag >= run1:
                            continue
                        for x in lanes:
                            e = base + x * p.vec
                            if e >= d:
                                continue
                            items = slice(i0, min(i0 + p.items, l))
                            adds[bag, items, e:e + p.vec] += 1
                            if last:
                                stores[bag, e:e + p.vec] += 1
                b0, i0 = (b0 + groups * p.bags, 0) if last else \
                    (b0, i0 + p.items)
    return p, adds, stores


@pytest.mark.parametrize("b,l,d,elt", [
    (1001, 1, 64, 4), (515, 1, 16, 4), (13, 26, 64, 4), (301, 1, 64, 2),
    (33, 8, 256, 4), (5, 7, 600, 4), (5, 7, 130, 4), (7, 4, 1, 4),
    (9, 6, 10, 4), (5, 33, 50, 4), (6, 0, 32, 4), (12, 8, 10, 2),
    (3, 4, 1032, 2), (40, 3, 24, 2), (77, 2, 64, 4), (4000, 1, 256, 4),
    (7, 3, 20, 4), (9, 2, 17, 4)])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 1])
def test_plan_adds_every_item_and_stores_every_element_once(b, l, d, elt,
                                                             aligned, sms):
    p, adds, stores = _plan_coverage(b, l, d, elt, aligned, sms)
    assert (adds == 1).all() and (stores == 1).all()
    assert p.vec == (16 // elt if aligned and d * elt % 16 == 0 else 1)
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
    if p.lanes == 32:                   # the warp kernel: a warp a bag
        assert (p.bags, p.items, p.bags_per_warp) \
            == (1, kernel.WARP_ROWS, 1) and p.ch in (1, 2)
    else:
        assert p.ch == 1 and p.bags * p.items == kernel.ROWS
        assert p.bags * max(l, 1) <= kernel.ROWS or p.bags == 1
    assert p.bags_per_warp % (32 // p.lanes * p.bags) == 0
    assert (p.grid - 1) * kernel.WARPS * p.bags_per_warp < max(b, 1)


def test_plan_at_serve_bulk():
    """The two serve_bulk shapes on an H100: the history bag's 1 KB rows
    take the warp kernel (a bag a warp, two 16-byte vectors a lane, two
    rows in flight); DLRM's 256-byte rows take the grouped kernel, two
    bags of one to a warp, 4 bags a group a step, runs cut for 64 warps a
    SM."""
    hist = kernel.plan(262_144, 8, 256, 4, True, 132)
    assert hist == kernel.Plan(vec=4, lanes=32, ch=2, bags=1, items=2,
                               bags_per_warp=1, grid=32_768, passes=1)
    dlrm = kernel.plan(6_815_744, 1, 64, 4, True, 132)
    assert (dlrm.vec, dlrm.lanes, dlrm.ch, dlrm.bags, dlrm.items) \
        == (4, 16, 1, 4, 1)
    warps = -(-6_815_744 // dlrm.bags_per_warp)
    assert 132 * kernel.WARPS_PER_SM // 2 <= warps \
        <= 132 * kernel.WARPS_PER_SM
