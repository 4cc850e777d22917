"""The port's containment join against the reference package's.

On the CPU the wrapper takes its plain version; it must equal the JAX
Pallas kernel, run as the reference's tests run it (interpret mode), bit
for bit at every shape of the reference's kernel tests, and the lazy
engine's containment.  Also: the wrapper's checks, its launch counter on
the CPU, and the ``engine_compare`` entry point at tiny sizes.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's card script)

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
        # a meta tensor takes the operator's fake implementation (shape and
        # type only); the eager implementation has no kernel for it
        args = [torch.empty(3, dtype=torch.int32, device="meta")] * 4
        out = interval_join(*args)
        assert (out.device.type, out.shape, out.dtype) == (
            "meta", (3,), torch.int32)
        with pytest.raises(err, match="no kernel"):
            join_kernel.interval_join_op._init_fn(*args, "contained_in", None)
        return
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


# --------------------------------------------------------------------- #
# the kernel's launch plan and its tiles' paths (kernel.plan, tile_paths)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("na,aligned,b_aligned,vec,vec_b", [
    (1, True, True, 4, 4),                  # below a tile: direct
    (2048, True, False, 4, 1),              # one tile (direct); B off 16
    (2049, False, True, 1, 4),              # two tiles; A off 16
    (25_253_635, False, False, 1, 1),       # J1, both off 16 bytes
])
def test_plan(na, aligned, b_aligned, vec, vec_b):
    p = join_kernel.plan(na, 2_651_251, aligned, b_aligned)
    assert (p.vec, p.vec_b) == (vec, vec_b)
    assert p.tile == join_kernel.TILE == 8 * p.threads
    assert (p.grid - 1) * p.tile < na <= p.grid * p.tile
    assert p.direct == (na <= p.tile) and p.budget % 4 == 0
    # a block's shared memory (B's keys and other ends over the window and
    # 2 x 64 entries of slack, and the tile's other ends) fits the static
    # 48 KB, and 8 blocks a SM
    shared = 4 * (2 * (p.budget + 2 * 64 + 8) + p.tile)
    assert shared <= 48 * 1024 and 8 * shared <= 227 * 1024


edge_lists = chip_smoke.join_window_lists    # a tile's window of w entries


def _packed(a, b, tail: int = 3):
    """(jax lists, torch lists) of A and B as given (A need not be a
    GC-list), int32, each with ``tail`` PAD entries after it, as ``pack``
    leaves them (so a one-tile A takes two tiles, not the direct plan)."""
    arrs = [np.concatenate([np.asarray(x, np.int64),
                            np.full(tail, int(tvec.PAD))]).astype(np.int32)
            for x in (*a, *b)]
    return ([jnp.asarray(x) for x in arrs],
            [torch.from_numpy(x.copy()) for x in arrs])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("delta,path", [(-1, "staged"), (0, "staged"),
                                        (1, "device")])
def test_window_budget_edge(mode, delta, path):
    """A tile whose window is one under, at and one over the budget: the
    first two are staged, the last is searched in device memory."""
    w = join_kernel.BUDGET + delta
    _, t = _packed(*edge_lists(w, mode, w))
    p = join_kernel.plan(t[0].shape[0], t[2].shape[0], True)
    paths = join_kernel.tile_paths(*t, mode, p)
    assert not p.direct and paths["windows"].tolist() == [w, -1]
    assert {k: paths[k] for k in ("staged", "device", "none")} == \
        {"staged": 0, "device": 0, "none": 1, path: 1}


def _no_order(a, b, seed):
    perm = np.random.default_rng(seed).permutation(len(a[0]))
    return (a[0][perm], a[1][perm]), b


def _pad_gaps(a, b, seed):
    s, e = chip_smoke.pad_gaps(a, seed)
    assert (s == int(tvec.PAD)).any() and (s[:-1] > s[1:]).any()
    return (s, e), b


def _all_pad(a, b, seed):
    pad = np.full(len(a[0]), int(tvec.PAD), np.int64)
    return (pad, pad), b


def _empty_b(a, b, seed):
    """B of one PAD entry, as ``pack`` makes an empty list (the port's
    side also takes B of no entries at all, below)."""
    return a, (np.full(1, int(tvec.PAD)), np.full(1, int(tvec.PAD)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case,delta,paths", [      # the last tile: PAD
    ("under_budget", -1, (1, 0, 1)),
    ("at_budget", 0, (1, 0, 1)),
    ("over_budget", 1, (0, 1, 1)),
    ("a_in_no_order", 0, "device"),
    ("a_with_pad_gaps", 0, None),
    ("all_pad_a", 0, (0, 0, 2)),
    ("empty_b", 0, (0, 0, 2)),
])
def test_join_matches_pallas_on_each_path(mode, case, delta, paths):
    """The plain version (the wrapper on the CPU) against the Pallas
    kernel in interpret mode, on lists that put tiles on each of the
    kernel's paths (``tile_paths`` under the wrapper's plan)."""
    seed = 100 + delta + 7 * len(case)
    lists = edge_lists(seed, mode, join_kernel.BUDGET + delta)
    if case == "a_in_no_order":       # two tiles of A, shuffled across
        lists = _no_order(*edge_lists(seed, mode, 2000, na=4000,
                                      nb=2600, first=300), seed)
    transform = {"a_with_pad_gaps": _pad_gaps, "all_pad_a": _all_pad,
                 "empty_b": _empty_b}.get(case)
    if transform is not None:
        lists = transform(*lists, seed)
    j, t = _packed(*lists)
    want = interval_join_pallas(*j, mode=mode, tile_a=2048, tile_b=1024)
    _check(interval_join(*t, mode=mode), want)
    if case == "empty_b":               # B of no entries at all
        t = [*t[:2], t[2][:0], t[3][:0]]
        _check(interval_join(*t, mode=mode), want)
    p = join_kernel.plan(t[0].shape[0], t[2].shape[0], True)
    got = join_kernel.tile_paths(*t, mode, p)
    counts = (got["staged"], got["device"], got["none"])
    if paths is None:                   # PAD gaps: a path but the tail's
        assert counts[2] == 1 and sum(counts) == p.grid
    elif paths == "device":             # every tile spans most of B
        assert p.grid > 1 and counts == (0, p.grid, 0)
    else:
        assert counts == paths
    assert not p.direct


def test_tile_paths_counts_tiles_not_elements():
    """A tile's path is decided by its valid entries alone; a PAD tail
    (``pack``'s) neither widens a window nor adds a tile."""
    (a_s, a_e), (b_s, b_e) = edge_lists(9, "contained_in", 300, na=2000)
    a_s, a_e, _ = pack(a_s, a_e, size=2 * join_kernel.TILE)   # PAD: 2 tiles
    b_s, b_e, _ = pack(b_s, b_e, size=2100)
    p = join_kernel.plan(a_s.shape[0], b_s.shape[0], True)
    got = join_kernel.tile_paths(a_s, a_e, b_s, b_e, "contained_in", p)
    assert p.grid == 2 and got["windows"].tolist() == [300, -1]
    assert (got["staged"], got["device"], got["none"]) == (1, 0, 1)


def test_counts_are_the_kernels():
    _, t = _both(random_gc_list(np.random.default_rng(4), 64),
                 random_gc_list(np.random.default_rng(5), 8))
    with pytest.raises(ValueError, match="counts"):
        interval_join(*t, counts=torch.zeros(3, dtype=torch.int32))


def test_chip_smoke_join_small_on_cpu(capsys):
    """chip_smoke.py's phase 4 on the CPU: its cases, the plain version
    against the dense definition, and each path case's first tile on its
    path by ``tile_paths`` (the card adds the kernel's own counts)."""
    assert chip_smoke.phase_join_small(torch.device("cpu")) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["phase"] == "join_small" and row["mismatches"] == 0
    assert set(chip_smoke.JOIN_PATH_CASES) <= set(row["cases"])
    assert all(row["tiles"][k] > 0 for k in ("staged", "device", "none"))
