"""The port's containment join against the reference package's.

On the CPU the wrapper takes its plain version; it must equal the JAX
Pallas kernel, run as the reference's tests run it (interpret mode), bit
for bit at every shape of the reference's kernel tests, and the lazy
engine's containment.  Also: the wrapper's checks, its launch counter on
the CPU, and the ``engine_compare`` entry point at tiny sizes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gcl as jgcl
from repro.core.annotation import reduce_minimal
from repro.core.vectorized import pack as jpack
from repro.kernels import interval_join as jax_join
from repro.kernels.interval_join.kernel import interval_join_pallas
from repro_torch.core import vectorized as tvec
from repro_torch.core.vectorized import pack
from repro_torch.kernels.interval_join import (contained_in_mask_ref,
                                               containing_mask_ref,
                                               interval_join)
from repro_torch.kernels.interval_join import kernel as join_kernel
from repro_torch.launch import engine_compare

MODES = ["contained_in", "containing"]


def random_gc_list(rng, n, span=10_000):
    starts = np.sort(rng.choice(span, size=n, replace=False)).astype(np.int64)
    ends = starts + rng.integers(0, 50, size=n)
    return reduce_minimal(starts, ends, np.zeros(n))


def _both(A, B):
    """The same packed lists for each package: (jax lists, torch lists)."""
    j = (*jpack(A.starts, A.ends)[:2], *jpack(B.starts, B.ends)[:2])
    t = (*pack(A.starts, A.ends)[:2], *pack(B.starts, B.ends)[:2])
    return j, t


def _check(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("na,nb", [(16, 16), (100, 37), (513, 257),
                                   (1000, 3)])
@pytest.mark.parametrize("mode", MODES)
def test_join_matches_pallas_sweep(na, nb, mode):
    rng = np.random.default_rng(na * 1000 + nb + len(mode))
    j, t = _both(random_gc_list(rng, na), random_gc_list(rng, nb))
    want = jax_join(*j, mode=mode, use_pallas=True, interpret=True)
    _check(interval_join(*t, mode=mode), want)


def test_join_matches_lazy_engine():
    rng = np.random.default_rng(7)
    A = random_gc_list(rng, 200, span=2000)
    B = random_gc_list(rng, 50, span=2000)
    lazy = {(p, q) for p, q, _ in
            jgcl.ContainedIn(jgcl.Term(A), jgcl.Term(B)).solutions()}
    _, t = _both(A, B)
    mask = interval_join(*t).numpy()[:len(A)]
    got = {(int(A.starts[i]), int(A.ends[i])) for i in np.flatnonzero(mask)}
    assert got == lazy


@pytest.mark.parametrize("mode", MODES)
def test_join_empty_lists(mode):
    empty = (np.array([], np.int64), np.array([], np.int64))
    one = (np.array([5], np.int64), np.array([9], np.int64))
    for a, b in [(empty, one), (one, empty), (empty, empty)]:
        j = (*jpack(*a)[:2], *jpack(*b)[:2])
        t = (*pack(*a)[:2], *pack(*b)[:2])
        want = jax_join(*j, mode=mode, use_pallas=True, interpret=True)
        got = interval_join(*t, mode=mode)
        _check(got, want)
        assert not got.any()


@pytest.mark.parametrize("a,b,contained,containing", [
    ((5, 9), (4, 10), 1, 0),
    ((4, 10), (5, 9), 0, 1),
    ((5, 9), (5, 9), 1, 1),
    ((5, 9), (20, 30), 0, 0),
])
def test_join_single_element(a, b, contained, containing):
    j = (*jpack([a[0]], [a[1]])[:2], *jpack([b[0]], [b[1]])[:2])
    t = (*pack([a[0]], [a[1]])[:2], *pack([b[0]], [b[1]])[:2])
    for mode, want in (("contained_in", contained),
                       ("containing", containing)):
        got = interval_join(*t, mode=mode)
        _check(got, jax_join(*j, mode=mode, use_pallas=True, interpret=True))
        assert int(got[0]) == want


@pytest.mark.parametrize("na,nb,tile", [(13, 5, 8), (20, 17, 8), (1, 9, 8),
                                        (257, 3, 128)])
@pytest.mark.parametrize("mode", MODES)
def test_join_list_length_not_tile_divisible(na, nb, tile, mode):
    rng = np.random.default_rng(na * 100 + nb + tile)
    j, t = _both(random_gc_list(rng, na, span=4000),
                 random_gc_list(rng, nb, span=4000))
    want = interval_join_pallas(*j, mode=mode, tile_a=tile, tile_b=tile)
    _check(interval_join(*t, mode=mode), want)


@pytest.mark.parametrize("mode", MODES)
def test_join_a_in_any_order(mode):
    """The contract asks order of B only: a shuffled A gives the shuffled
    mask."""
    rng = np.random.default_rng(3)
    A = random_gc_list(rng, 600, span=8000)
    B = random_gc_list(rng, 90, span=8000)
    _, (a_s, a_e, b_s, b_e) = _both(A, B)
    perm = torch.from_numpy(rng.permutation(a_s.shape[0]))
    whole = interval_join(a_s, a_e, b_s, b_e, mode=mode)
    got = interval_join(a_s[perm].contiguous(), a_e[perm].contiguous(),
                        b_s, b_e, mode=mode)
    assert torch.equal(got, whole[perm])


def test_plain_masks_and_bool_view():
    rng = np.random.default_rng(5)
    _, t = _both(random_gc_list(rng, 300), random_gc_list(rng, 40))
    assert torch.equal(contained_in_mask_ref(*t), interval_join(*t))
    assert torch.equal(containing_mask_ref(*t),
                       interval_join(*t, mode="containing"))
    m = tvec.contained_in_mask(*t)
    assert m.dtype == torch.bool and torch.equal(m, interval_join(*t) != 0)
    m = tvec.containing_mask(*t)
    assert m.dtype == torch.bool and torch.equal(
        m, interval_join(*t, mode="containing") != 0)


def test_cpu_path_never_launches():
    rng = np.random.default_rng(6)
    _, t = _both(random_gc_list(rng, 64), random_gc_list(rng, 8))
    before = join_kernel.launches
    for mode in MODES:
        interval_join(*t, mode=mode)
    assert join_kernel.launches == before


def _i32(*xs):
    return torch.tensor(xs, dtype=torch.int32)


@pytest.mark.parametrize("case", ["mode", "dtype", "two_d", "lengths",
                                  "devices", "device_type"])
def test_wrapper_rejects_bad_inputs(case):
    x = _i32(1, 2, 3)
    args = [x, x, x, x]
    kwargs = {}
    err = ValueError
    if case == "mode":
        kwargs["mode"] = "overlaps"
    elif case == "dtype":
        args[1], err = x.long(), TypeError
    elif case == "two_d":
        args[2] = args[3] = x.view(1, 3)
    elif case == "lengths":
        args[1] = _i32(1, 2)
    elif case == "devices":
        args[2] = args[3] = torch.empty(3, dtype=torch.int32, device="meta")
    else:
        args = [torch.empty(3, dtype=torch.int32, device="meta")] * 4
    with pytest.raises(err):
        interval_join(*args, **kwargs)


def test_engine_compare_cpu_smoke(capsys):
    assert engine_compare.main(["--device", "cpu", "--sizes", "50", "400",
                                "--docs", "3000", "--postings", "200",
                                "--repeats", "1"]) == 0
    out = capsys.readouterr().out
    assert "containment join" in out and "bm25_blockmax" in out
    rows = engine_compare.bench_joins((300,), "cpu", repeats=1)
    assert rows[0]["n"] == 300 and rows[0]["matches"] > 0


def test_engine_compare_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_compare.main(["--sizes", "10"])
