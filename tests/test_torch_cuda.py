"""On the card: the CUDA kernels and the device scorer against their plain
versions.  Every test here needs a CUDA card and skips without one.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs on a
machine with PyTorch alone.
"""

import ctypes
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro_torch.configs import recsys_family
from repro_torch.configs.lm_family import get_config
from repro_torch.core.annotation import reduce_minimal
from repro_torch.core.vectorized import (bm25_topk, contained_in, pack,
                                         stable_topk)
from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                               bm25_blockmax_topk,
                                               bm25_topk_ref, kernel, ref)
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_padded_ref, take)
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
from repro_torch.kernels.interval_join import (contained_in_mask_ref,
                                               containing_mask_ref,
                                               interval_join)
from repro_torch.kernels.interval_join import kernel as join_kernel
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import LMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _sparse(seed, t, nb, bs, fill):
    rng = np.random.default_rng(seed)
    imp = rng.random((t, nb, bs), dtype=np.float32)
    imp *= rng.random((t, nb, bs)) < fill
    return torch.from_numpy(imp.astype(np.float32))


@pytest.mark.parametrize("t,nb,bs", [(4, 8, 128), (3, 5, 100), (2, 3, 7),
                                     (3, 2, 1500), (0, 4, 128), (1, 1, 1)]
                         + [c[1:] for c in chip_smoke.SWEEP_EDGES])
def test_sweep_bitwise_equals_plain(cuda_device, t, nb, bs):
    """The kernel tests' shapes and ``chip_smoke.py``'s edges (the last,
    impacts off 16 bytes, on the scalar path)."""
    imp = _sparse(t + nb, t, nb, bs, 0.2)
    imp = chip_smoke.off_16(imp, cuda_device) \
        if (t, nb, bs) == chip_smoke.SWEEP_EDGES[-1][1:] \
        else imp.to(cuda_device)
    bmax = imp.amax(2)
    ub = ref.term_sum(bmax)
    for theta in (ub.median().reshape(1), torch.zeros(1, device=cuda_device)):
        before = kernel.launches
        got = blockmax_scores(imp, bmax, theta)
        assert kernel.launches == before + 1
        assert torch.equal(got, ref.blockmax_scores(imp, bmax, theta))
        assert torch.equal(got.cpu(), ref.blockmax_scores(
            imp.cpu(), bmax.cpu(), theta.cpu()))


def test_launch_plans_are_the_library_s(cuda_device):
    """The wrappers' WARPS and embedding_bag's rows in flight are what the
    libraries were built with."""
    from repro_torch.kernels import build
    assert build.load("bm25_blockmax").bm25_blockmax_warps() == kernel.WARPS
    lib = build.load("embedding_bag")
    assert (lib.embedding_bag_warps(), lib.embedding_bag_rows(),
            lib.embedding_bag_warp_rows()) \
        == (bag_kernel.WARPS, bag_kernel.ROWS, bag_kernel.WARP_ROWS)


def test_launchers_refuse_a_grid_that_leaves_output_unwritten(cuda_device):
    """17 doc blocks or 17 bags need 3 blocks of 8 warps: at 2 the
    launchers return cudaErrorInvalidConfiguration (9), launching
    nothing; at 3 they launch."""
    stream = torch.cuda.current_stream().cuda_stream
    imp = torch.zeros(2, 17, 128, device=cuda_device)
    bmax = torch.zeros(2, 17, device=cuda_device)
    theta = torch.zeros(1, device=cuda_device)
    out = torch.empty(17, 128, device=cuda_device)
    sweep = (imp.data_ptr(), bmax.data_ptr(), theta.data_ptr(),
             out.data_ptr(), 2, 17, 128, 1)
    table = torch.zeros(5, 128, device=cuda_device)
    ids = torch.zeros(17, 3, dtype=torch.int32, device=cuda_device)
    w = torch.ones(17, 3, device=cuda_device)
    # a warp a bag: float32, 16-byte loads, 32 lanes, one vector a lane
    bag = (table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
           5, 17, 3, 128, 0, 1, 5, 1, 1, 1)
    for launch, args in ((kernel._launcher(), sweep),
                         (bag_kernel._launcher(), bag)):
        assert launch(*args, 2, stream) == 9
        assert launch(*args, 3, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_topk_matches_exhaustive_and_host(cuda_device):
    imp = _sparse(1, 8, 32, 128, 0.1)
    got = bm25_blockmax_topk(imp.to(cuda_device), imp.amax(2).to(cuda_device),
                             k=25)
    want = bm25_topk_ref(imp, 25)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_wrapper_rejects_non_contiguous(cuda_device):
    imp = torch.zeros(2, 8, 3, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        blockmax_scores(imp, torch.zeros(2, 3, device=cuda_device),
                        torch.zeros(1, device=cuda_device))


def test_dense_scorer_matches_host(cuda_device):
    rng = np.random.default_rng(4)
    q, t, l, n = 4, 8, 256, 4096
    doc_idx = np.full((q, t, l), n, np.int32)
    impacts = np.zeros((q, t, l), np.float32)
    for qi in range(q):
        for ti in range(t):
            m = int(rng.integers(0, l))
            doc_idx[qi, ti, :m] = rng.choice(n, m, replace=False)
            impacts[qi, ti, :m] = rng.choice([0.5, 1.25, 2.0], m)
    qmask = np.ones((q, t), np.float32)
    args = [torch.from_numpy(a) for a in (doc_idx, impacts, qmask)]
    want = bm25_topk(*args, n_docs=n, k=50)
    got = bm25_topk(*[a.to(cuda_device) for a in args], n_docs=n, k=50)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_stable_topk_on_card_matches_host(cuda_device):
    x = torch.from_numpy(np.random.default_rng(2).choice(
        np.array([0.0, 1.0, 2.0], np.float32), size=(3, 10_000)))
    got = stable_topk(x.to(cuda_device), 500)
    want = stable_topk(x, 500)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


# ------------------------------------------------------------------ #
# interval_join
# ------------------------------------------------------------------ #
JOIN_MODES = {"contained_in": contained_in_mask_ref,
              "containing": containing_mask_ref}


def _gc(seed, n, span):
    """A G-reduced list (starts, ends) as the kernel tests draw one."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(span, size=n, replace=False))
    ends = starts + rng.integers(0, 50, size=n)
    lst = reduce_minimal(starts.astype(np.int64), ends.astype(np.int64),
                         np.zeros(n))
    return lst.starts, lst.ends


@pytest.mark.parametrize("na,nb,span", [
    (16, 16, 10_000), (100, 37, 10_000), (513, 257, 10_000),
    (1000, 3, 10_000), (13, 5, 4000), (20, 17, 4000), (1, 9, 4000),
    (257, 3, 4000), (5000, 700, 60_000), (0, 4, 100), (4, 0, 100),
    (0, 0, 100)])
@pytest.mark.parametrize("mode", list(JOIN_MODES))
def test_interval_join_equals_plain(cuda_device, na, nb, span, mode):
    a = _gc(na * 1000 + nb, na, span)
    b = _gc(nb * 7 + na, nb, span)
    a_s, a_e, _ = pack(*a, size=na + 3, device=cuda_device)   # PAD tails
    b_s, b_e, _ = pack(*b, size=nb + 3, device=cuda_device)
    before = join_kernel.launches
    got = interval_join(a_s, a_e, b_s, b_e, mode=mode)
    assert join_kernel.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, JOIN_MODES[mode](a_s, a_e, b_s, b_e))
    assert torch.equal(got.cpu(), JOIN_MODES[mode](
        a_s.cpu(), a_e.cpu(), b_s.cpu(), b_e.cpu()))


@pytest.mark.parametrize("a,b,contained,containing", [
    ((5, 9), (4, 10), 1, 0), ((4, 10), (5, 9), 0, 1),
    ((5, 9), (5, 9), 1, 1), ((5, 9), (20, 30), 0, 0)])
def test_interval_join_single_element(cuda_device, a, b, contained,
                                      containing):
    a_s, a_e, _ = pack([a[0]], [a[1]], device=cuda_device)
    b_s, b_e, _ = pack([b[0]], [b[1]], device=cuda_device)
    assert int(interval_join(a_s, a_e, b_s, b_e)[0]) == contained
    assert int(interval_join(a_s, a_e, b_s, b_e,
                             mode="containing")[0]) == containing


def test_interval_join_zero_length_lists(cuda_device):
    a_s, a_e, _ = pack([3, 8], [4, 9], device=cuda_device)
    empty = a_s[:0]
    for mode in JOIN_MODES:
        assert not interval_join(a_s, a_e, empty, empty, mode=mode).any()
        before = join_kernel.launches
        assert interval_join(empty, empty, a_s, a_e, mode=mode).numel() == 0
        assert join_kernel.launches == before


def test_interval_join_rejects_bad_input(cuda_device):
    x = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        interval_join(x[::2], x[::2], x, x)
    with pytest.raises(TypeError, match="int32"):
        interval_join(x.long(), x.long(), x, x)
    with pytest.raises(ValueError, match="is on"):
        interval_join(x, x, x.cpu(), x.cpu())


def _join_case(name, device):
    """chip_smoke's join case ``name``, packed on ``device`` with 3 PAD
    entries after each list, placed off 16 bytes where it says so."""
    (a, b, modes, first_path), = [c[1:] for c in chip_smoke.join_small_cases()
                                  if c[0] == name]
    a_s, a_e, _ = pack(*a, size=len(a[0]) + 3, device=device)
    b_s, b_e, _ = pack(*b, size=len(b[0]) + 3, device=device)
    if name == "a_off_16_bytes":
        a_s, a_e = (chip_smoke.off_16(x, device) for x in (a_s, a_e))
    if name == "b_off_16_bytes":
        b_s, b_e = (chip_smoke.off_16(x, device) for x in (b_s, b_e))
    return (a_s, a_e, b_s, b_e), modes, first_path


@pytest.mark.parametrize("case", chip_smoke.JOIN_PATH_CASES)
def test_interval_join_paths(cuda_device, case):
    """Tiles on each of the kernel's paths — the window one under, at and
    one over the budget, A in no order, sparse A over dense B (the wide
    tiles' kernel), PAD gaps, all PAD, A or B off 16 bytes: exact against
    the plain version on the card and on the host, one launch a call, and
    the kernel's tiles by path those of ``tile_paths``."""
    lists, modes, first_path = _join_case(case, cuda_device)
    for mode in modes:
        counts = torch.zeros(3, dtype=torch.int32, device=cuda_device)
        before = join_kernel.launches
        got = interval_join(*lists, mode=mode, counts=counts)
        assert join_kernel.launches == before + 1
        assert torch.equal(got, JOIN_MODES[mode](*lists))
        assert torch.equal(got.cpu(), JOIN_MODES[mode](
            *(x.cpu() for x in lists)))
        paths = chip_smoke.join_paths(*lists, mode, counts)
        if first_path is not None:
            w = int(paths["windows"][0])
            assert (w < 0, 0 <= w <= paths["budget"]) == \
                (first_path == "none", first_path == "staged")


def _shuffled_join(device, n=600_000, nb=40_000, seed=21):
    """A of ``n`` entries in no order over a GC-list B, packed on
    ``device``: about 290 tiles, more than a grid that searches its wide
    tiles in place, so the wide tiles' kernel is tail-launched."""
    rng = np.random.default_rng(seed)
    a_s = np.cumsum(rng.integers(2, 60, n))
    a_e = a_s + rng.integers(0, 2, n)
    b_s = np.cumsum(rng.integers(100, 1500, nb))
    b_e = b_s + rng.integers(0, 90, nb)
    perm = rng.permutation(n)
    return [*pack(a_s[perm], a_e[perm], device=device)[:2],
            *pack(b_s, b_e, device=device)[:2]]


def test_interval_join_tail_launch_and_counter(cuda_device):
    """Wide tiles past the in-place grid go to the tail-launched kernel:
    exact on the default stream and on a side stream, before and after a
    staged launch, and the launch's counter is zero after each."""
    wide = _shuffled_join(cuda_device)
    staged, _, _ = _join_case("window_at_budget_containing", cuda_device)
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for lists in (wide, staged, wide):
                for mode in JOIN_MODES:
                    counts = torch.zeros(3, dtype=torch.int32,
                                         device=cuda_device)
                    got = interval_join(*lists, mode=mode, counts=counts)
                    assert torch.equal(got, JOIN_MODES[mode](*lists))
                    chip_smoke.join_paths(*lists, mode, counts)
            ctrl = join_kernel._ctrl(wide[0].device, stream.cuda_stream)
        torch.cuda.synchronize()
        assert ctrl.tolist() == [0]
    paths = chip_smoke.join_paths(*wide, "contained_in")
    assert paths["device"] > 132 and paths["staged"] == 0


def test_vectorized_contained_in_on_card_matches_host(cuda_device):
    a = _gc(3, 2000, 40_000)
    b = _gc(4, 300, 40_000)
    host = [pack(*a, values=np.arange(len(a[0]), dtype=np.float32)),
            pack(*b)]
    card = [[t.to(cuda_device) for t in lst] for lst in host]
    before = join_kernel.launches
    got = contained_in(*card[0], *card[1][:2])
    assert join_kernel.launches == before + 1
    want = contained_in(*host[0], *host[1][:2])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ------------------------------------------------------------------ #
# gqa_decode
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_decode_equals_plain(cuda_device, case, dtype):
    """The cases of ``chip_smoke.py``'s ``decode_small``, at the kernel
    tests' tolerances."""
    b, hkv, g, d, s, lengths = case
    rng = np.random.default_rng(b * 100 + s + g)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((b, hkv, g, d), (b, s, hkv, d),
                                             (b, s, hkv, d)))
    if lengths is None:
        lengths = rng.integers(1, s + 1, size=b)
    length = torch.tensor(lengths, dtype=torch.int32)
    host = gqa_decode_ref(q, k, v, length)
    args = [x.to(cuda_device) for x in (q, k, v, length)]
    before = gqa_kernel.launches
    got = gqa_decode(*args)
    assert gqa_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = chip_smoke.DECODE_TOL[str(dtype).split(".")[-1]]
    for want in (gqa_decode_ref(*args), host.to(cuda_device)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_gqa_decode_rejects_misaligned(cuda_device):
    buf = torch.zeros(2 * 2 * 5 * 16 + 1, device=cuda_device)
    q = buf[1:].view(2, 2, 5, 16)                  # contiguous, 4 B off
    k = torch.zeros(2, 8, 2, 16, device=cuda_device)
    n = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        gqa_decode(q, k, k, n)


def test_decode_step_on_card_runs_the_kernel_only(cuda_device, monkeypatch):
    """n_layers launches a step, and never the plain version."""
    def no_plain(*args):
        raise AssertionError("decode_step on the card took the plain "
                             "version")
    monkeypatch.setattr(gqa_kernel, "gqa_decode_ref", no_plain)
    cfg = get_config("qwen2.5-14b", smoke=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = TT.init_params(cfg, gen, cuda_device)
    cache = TT.init_cache(cfg, 3, 16, device=cuda_device)
    before = gqa_kernel.launches
    for step in range(5):
        toks = torch.tensor([1, 2, 3], device=cuda_device) + step
        logits, _ = TT.decode_step(model, cache, toks)
    torch.cuda.synchronize()
    assert gqa_kernel.launches == before + 5 * cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert cache["length"].tolist() == [5, 5, 5]


def test_span_covers_the_device_idle_gap(cuda_device):
    """Under the profiler, a span around two launches and a 2 ms host
    wait between them covers the device's idle gap between their
    kernels, once the span clock is tied to the profiler's host clock
    and the device's skew is out: the launch calls lie in the span and
    each end of the gap in its launch call, each to within 50 µs; the gap
    goes to the span.  (On an H100 a launch call took 10-45 µs under
    the profiler, its kernel ran before it returned, and the host then
    spent 20-50 µs of Python before the next line; the wait spins, since
    after ``time.sleep`` the host took 0.1 ms to reach the next launch.)
    """
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import Tracer, timeline
    tr = Tracer()
    x = torch.ones(1 << 20, device=cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]):   # its start-up
        x.add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark = timeline.sync_mark()
        x.add_(1)                # the window's first activity
        torch.cuda.synchronize()
        with tr.span("wait"):
            x.add_(1)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.002:
                pass
            x.add_(1)
        torch.cuda.synchronize()
    events = timeline.from_profiler(prof.events())
    offset = timeline.clock_offset_ns(events, mark)
    assert offset[1] < 25_000, offset
    ops = sorted((e for e in events if e.on_device),
                 key=lambda e: e.start_ns)
    assert len(ops) == 3, ops
    span = tr.traces()[0].root
    skew = timeline.device_skew_ns(events)
    gap = (ops[1].end_ns - skew, ops[2].start_ns - skew)
    calls = {e.corr: e for e in events if not e.on_device}
    first, second = calls[ops[1].corr], calls[ops[2].corr]
    tol = 50_000
    assert span.start_ns + offset[0] - tol < first.start_ns, (span, first)
    assert second.end_ns < span.end_ns + offset[0] + tol, (span, second)
    assert first.start_ns - tol < gap[0] < first.end_ns + tol, (gap, first)
    assert second.start_ns - tol < gap[1] < second.end_ns + tol, (
        gap, second)
    out = timeline.attribute(events, [span], offset)
    assert out["ops_unmatched"] == 0 and out["calls_without_op"] == 0, out
    assert out["launches"] == {"outside": 1, "wait": 2}, out
    assert out["idle_s"]["wait"] >= 0.0019, out


def test_moe_counters_reach_the_registry_from_the_card(cuda_device):
    """The MoE counters that ``moe_block`` sums on the card reach the
    registry's snapshot (its collector flushes them) equal to a count by
    loops over the same call's ``moe_dispatch`` outputs: at capacity
    factor 1.0 assignments drop."""
    from repro_torch import obs
    from repro_torch.models import transformer as TT
    e, k, t, d, f = 8, 2, 96, 16, 8
    cfg = TT.TransformerConfig(
        name="moe-count", n_layers=1, d_model=d, n_heads=1, n_kv_heads=1,
        d_ff=f, vocab=8, dtype="float32",
        moe=TT.MoEConfig(n_experts=e, top_k=k, d_expert_ff=f,
                         capacity_factor=1.0))
    g = torch.Generator().manual_seed(2)
    shapes = {"router": (d, e), "e_gate": (e, d, f), "e_up": (e, d, f),
              "e_down": (e, f, d)}
    lp = {n: torch.randn(s, generator=g).to(cuda_device)
          for n, s in shapes.items()}
    x = torch.randn(t, d, generator=g).to(cuda_device)
    probs = torch.softmax(x @ lp["router"], dim=-1)
    _, top_e, pos, keep, idx_buf = (a.cpu() for a in
                                    TT.moe_dispatch(probs, cfg.moe))
    kept = int(keep.sum())
    lost = sum(int(idx_buf[top_e[i, j], pos[i, j]]) != i
               for i, j in keep.nonzero().tolist())
    want = [kept, t * k - kept, lost, idx_buf.numel()]
    names = ["lm_moe_assignments_kept_total",
             "lm_moe_assignments_dropped_total", "lm_moe_kept_lost_total",
             "lm_moe_slots_total"]

    def read():
        snap = obs.registry().snapshot()
        return [snap[n]["series"][0]["value"] if n in snap else 0
                for n in names]

    was = obs.registry().enabled
    obs.registry().enable()
    try:
        before = read()
        TT.moe_block(x, lp, cfg)
        got = [a - b for a, b in zip(read(), before)]
    finally:
        obs.registry().enabled = was
    assert got == want and want[1] > 0, (got, want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_lmserver_on_card_matches_host(cuda_device, arch):
    """The same float32 weights on the card and on the host: equal logits
    within 2e-4 (the CPU parity tolerance) at every step, equal tokens
    (the MoE smoke config at 4 slots: capacity 3, which binds)."""
    cfg = get_config(arch, smoke=True)
    host = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = TT.Transformer(cfg, cuda_device)
    card.load_state_dict(host.state_dict())
    logs = {}
    outs = {}
    prompts = [[5, 9, 2, 11, 40], [7, 4], [300, 1, 2]]
    for name, model, dev in (("host", host, "cpu"),
                             ("card", card, cuda_device)):
        server = LMServer(model, max_slots=4, max_len=16, device=dev)
        logs[name] = []
        step = server.step

        def recording(tokens, step=step, log=logs[name]):
            out = step(tokens)
            log.append(out.cpu())
            return out
        server.step = recording
        outs[name] = server.generate(prompts, max_new=5)
    assert outs["card"] == outs["host"]
    for a, b in zip(logs["card"], logs["host"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ #
# moe_block and moe_dispatch (no kernel: the card's products and integer
# dispatch against the host's)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.MOE_SMALL_CASES,
                         ids=[c[0] for c in chip_smoke.MOE_SMALL_CASES])
def test_moe_block_on_card_matches_host(cuda_device, case, dtype):
    """The cases of ``chip_smoke.py``'s ``moe_small``: the dispatch exact
    on the card and on the host against the reference's order
    (``dispatch_model``), two card calls the same bits, the output within
    ``recsys_close``'s tolerance, the probes' zeroed tokens zero."""
    row = chip_smoke.check_moe_case(cuda_device, case, dtype)
    assert row["ok"]


# ------------------------------------------------------------------ #
# embedding_bag
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", chip_smoke.BAG_CASES,
                         ids=[c[0] for c in chip_smoke.BAG_CASES])
def test_embedding_bag_equals_plain(cuda_device, case):
    """The cases of ``chip_smoke.py``'s ``bag_small``: bit for bit against
    the plain version on the card and on the host; bags of one are take."""
    table, idx, w = chip_smoke.bag_case(*case)
    host = embedding_bag_padded_ref(table, idx, w)
    t = (chip_smoke.off_16(table, cuda_device)
         if case[0] == "table_off_16_bytes" else table.to(cuda_device))
    i, ww = idx.to(cuda_device), w.to(cuda_device)
    before = bag_kernel.launches
    got = embedding_bag(t, i, ww)
    assert bag_kernel.launches == before + int(idx.shape[0] > 0)
    assert got.dtype == table.dtype and got.shape == host.shape
    assert chip_smoke.same_bits(got, embedding_bag_padded_ref(t, i, ww))
    assert chip_smoke.same_bits(got.cpu(), host)
    flat = i.reshape(-1, 1)
    one = embedding_bag(t, flat, torch.ones(flat.shape, device=cuda_device))
    assert chip_smoke.same_bits(one, take(t, flat[:, 0]))


def test_embedding_bag_rejects_bad_input(cuda_device):
    table = torch.randn(50, 16, device=cuda_device)
    idx = torch.randint(0, 50, (8, 4), dtype=torch.int32,
                        device=cuda_device)
    w = torch.rand(8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table, idx.t().contiguous().t(),
                      w.t().contiguous().t())
    with pytest.raises(TypeError, match="int32"):
        embedding_bag(table, idx.long(), w)
    with pytest.raises(TypeError, match="table"):
        embedding_bag(table.double(), idx, w)
    with pytest.raises(ValueError, match="is on"):
        embedding_bag(table, idx.cpu(), w)
    # a table off 16 bytes is not refused: it takes scalar loads
    off = chip_smoke.off_16(table.cpu(), cuda_device)
    assert torch.equal(embedding_bag(off, idx, w),
                       embedding_bag(table, idx, w))


@pytest.mark.parametrize("name,cands", [
    ("dlrm-rm2", False), ("xdeepfm", False), ("two-tower-retrieval", False),
    ("two-tower-retrieval", True), ("sasrec", False), ("sasrec", True)])
def test_recsys_on_card_runs_the_kernel_only(cuda_device, monkeypatch, name,
                                             cands):
    """Each model at its smoke config on the card: the fixed launches a
    call, never the plain version, and the host's numbers within phase
    12's tolerance."""
    def no_plain(*args):
        raise AssertionError(f"{name} on the card took the plain version")
    cfg = recsys_family.get_config(name, smoke=True)
    host = TR.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = TR.make_model(cfg, cuda_device)
    card.load_state_dict(host.state_dict())
    batch = recsys_family.smoke_batch(name, "serve" if cands else "train")
    want = recsys_family.serve(name, host, batch)
    want64 = recsys_family.serve(name, host.double(), batch)
    monkeypatch.setattr(bag_kernel, "embedding_bag_padded_ref", no_plain)
    before = bag_kernel.launches
    got = recsys_family.serve(name, card, batch)
    torch.cuda.synchronize()
    per_call = {"dlrm-rm2": 1, "xdeepfm": 2, "two-tower-retrieval": 2,
                "sasrec": 1}[name] + int(cands)
    assert bag_kernel.launches == before + per_call
    assert chip_smoke.recsys_close(got, want, want64)["ok"]


# ------------------------------------------------------------------ #
# embedding_bag's backward and recsys training
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", chip_smoke.BAG_BACKWARD_CASES,
                         ids=[c[0] for c in chip_smoke.BAG_BACKWARD_CASES])
def test_embedding_bag_backward_equals_plain(cuda_device, case):
    """The cases of ``chip_smoke.py``'s ``bag_backward_small``: bit for bit
    (NaN masks equal) against the plain model of the kernel's order, and
    within n · 2^-23 · Σ|terms| an element (plus a bfloat16 ulp for
    bfloat16) of the item-order plain version, one launch a call."""
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward, embedding_bag_backward_ref,
        embedding_bag_backward_sorted_ref)
    name, v, d, b, l, dtype = case[:6]
    g, idx, w = chip_smoke.bag_backward_case(*case)
    dt = getattr(torch, dtype)
    host = embedding_bag_backward_ref(g, idx, w, v).to(dt)
    bound = chip_smoke.bag_backward_bound(g, idx, w, v)
    gd = (chip_smoke.off_16(g, cuda_device)
          if name == "grad_out_off_16_bytes" else g.to(cuda_device))
    i, ww = idx.to(cuda_device), w.to(cuda_device)
    before = bag_kernel.backward_launches
    got = embedding_bag_backward(gd, i, ww, v)
    assert bag_kernel.backward_launches == before + int(b > 0)
    assert got.dtype == dt and got.shape == (v, d)
    assert chip_smoke.same_bits(
        got, embedding_bag_backward_sorted_ref(gd, i, ww, v).to(dt))
    assert chip_smoke.bag_backward_close(got.cpu(), host, bound)[2]


@pytest.mark.parametrize("case", [c for c in chip_smoke.BAG_BACKWARD_CASES
                                  if c[6] in ("hot", "runs", "dup")],
                         ids=lambda c: c[0])
def test_embedding_bag_backward_same_bits_twice(cuda_device, case):
    """Two calls on the same inputs give the same bits, on two streams
    too: the sum order depends on the inputs alone."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward
    v = case[1]
    g, idx, w = (x.to(cuda_device) for x in chip_smoke.bag_backward_case(
        *case))
    first = embedding_bag_backward(g, idx, w, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = embedding_bag_backward(g, idx, w, v)
    torch.cuda.current_stream().wait_stream(side)
    assert chip_smoke.same_bits(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_backward_nonfinite_zero_weight_items(cuda_device,
                                                            dtype):
    """Fault (s): a zero-weight item whose bag's grad_out row holds an inf
    or a NaN puts NaN in its row exactly where that row is non-finite, as
    the plain version does; one of a finite row, or of an id out of range,
    adds nothing."""
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward, embedding_bag_backward_ref)
    g = torch.tensor([[np.inf, 1.0, 2.0, -1.0], [1.0, np.nan, 3.0, 4.0],
                      [5.0, 6.0, 7.0, 8.0]]).to(dtype)
    ids = torch.tensor([[1, 0], [2, 9], [3, 0]], dtype=torch.int32)
    w = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, 2.0]])
    got = embedding_bag_backward(g.to(cuda_device), ids.to(cuda_device),
                                 w.to(cuda_device), 5).cpu()
    want = embedding_bag_backward_ref(g, ids, w, 5).to(dtype)
    assert chip_smoke.same_bits(got, want)
    assert torch.isnan(got[0]).tolist() == [True, False, False, False]
    assert torch.isnan(got[2]).tolist() == [False, True, False, False]
    assert not torch.isnan(got[[1, 3, 4]]).any()


def test_embedding_bag_backward_library_constants(cuda_device):
    """The library's warps a block, piece length and sort digits are the
    plan's, and its workspace formula is ``backward_workspace``'s."""
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import PIECE
    lib = build.load(bag_kernel.BACKWARD)
    assert lib.embedding_bag_backward_warps() == bag_kernel.WARPS
    assert lib.embedding_bag_backward_piece() == PIECE
    assert lib.embedding_bag_backward_radix_bits() == bag_kernel.SORT_BITS
    words = lib.embedding_bag_backward_workspace_words
    words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    words.restype = ctypes.c_longlong
    for n, grid, d in [(1, 2, 1), (1703936, 264, 64), (524288, 264, 256),
                       (33, 7, 10)]:
        assert words(n, grid, d) == bag_kernel.backward_workspace(n, grid, d)


def test_backward_launches_once_per_lookup(cuda_device, monkeypatch):
    """A DLRM smoke training step on the card launches the forward and the
    backward kernel once each (one lookup), never the plain backward."""
    from repro_torch.kernels.embedding_bag import kernel as k

    def no_plain(*args):
        raise AssertionError("the card took the plain backward")
    monkeypatch.setattr(k, "embedding_bag_backward_ref", no_plain)
    cfg = recsys_family.get_config("dlrm-rm2", smoke=True)
    model = TR.init_params(cfg, torch.Generator().manual_seed(1),
                           "cpu").to(cuda_device).requires_grad_(True)
    batch = recsys_family.smoke_batch("dlrm-rm2", "train")
    f0, b0 = k.launches, k.backward_launches
    recsys_family.loss_fn("dlrm-rm2", model, batch).backward()
    torch.cuda.synchronize()
    assert (k.launches - f0, k.backward_launches - b0) == (1, 1)
    assert model.tables.grad is not None


def test_dlrm_train_step_on_card_matches_host(cuda_device):
    """One DLRM smoke training step on the card against the same step on
    the CPU: the parameters within ``chip_smoke.params_close``'s bound
    (the host's float32-vs-float64 spread, or an AdamW direction)."""
    cfg = recsys_family.get_config("dlrm-rm2", smoke=True)
    batch = recsys_family.smoke_batch("dlrm-rm2", "train", seed=2)

    def make(dev):
        m = TR.init_params(cfg, torch.Generator().manual_seed(3),
                           "cpu").to(dev)
        return chip_smoke.recsys_trainer("dlrm-rm2", cfg, m, batch, 1)
    card = make(cuda_device)
    card.train()
    ref32, ref64 = chip_smoke.host_runs(make)
    got = {n: p.detach() for n, p in card.model.named_parameters()}
    chip_smoke.params_close(got, ref32, ref64, 1e-3, 1)


@pytest.mark.parametrize("name", ["dlrm-rm2", "two-tower-retrieval",
                                  "internlm2-1.8b"])
def test_train_step_makes_no_host_sync(cuda_device, name):
    """A training step (loss, backward with the kernels, AdamW) reads
    nothing back to the host: two profiled steps make no more stream,
    device or event syncs and no more synchronous copies than one (the
    profiler's own cancel).  Two-tower streams its softmax (loss_chunk 4
    of 8); the LM runs remat and blocked attention."""
    import dataclasses
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import lm_family
    from repro_torch.train.optimizer import init_opt_state, make_train_step
    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy")
    if name == "internlm2-1.8b":
        cfg = dataclasses.replace(get_config(name, smoke=True), remat=True,
                                  attn_chunk_q=16, attn_chunk_kv=16)
        model = TT.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(cuda_device)
        batch = lm_family.smoke_batch(cfg, "train")
        loss = lm_family.loss_fn
    else:
        cfg = recsys_family.get_config(name, smoke=True)
        if name == "two-tower-retrieval":
            cfg = dataclasses.replace(cfg, loss_chunk=4)
        model = TR.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(cuda_device)
        batch = recsys_family.smoke_batch(name, "train")

        def loss(m, b):
            return recsys_family.loss_fn(name, m, b)
    batch = {k: torch.as_tensor(v, device=cuda_device)
             for k, v in batch.items()}
    model.requires_grad_(True)
    state = init_opt_state(model)
    step = make_train_step(loss)
    step(model, state, batch)                      # warm-up
    torch.cuda.synchronize()

    def window(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(model, state, batch)
        names = Counter(e.name for e in prof.events())
        assert names["cudaLaunchKernel"] > 0
        return Counter({k: names[k] for k in syncs if names[k]})
    one, two = window(1), window(2)
    assert two - one == Counter(), (one, two)


# ------------------------------------------------------------------ #
# sharded serving
# ------------------------------------------------------------------ #
SHARDED_QUERIES = ["school education student", "government law state",
                   "stock money business", "vibration conductor wind",
                   "time", "nothingmatches", "wind wind conductor",
                   "people way day man thing woman life child world"]


@pytest.fixture(scope="module")
def sharded_warren():
    from repro_torch.core import ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.dist.shard_router import ShardedWarren
    w = ShardedWarren(n_shards=3, replicas=2, async_scatter=True)
    ingest_documents(w, doc_generator(7, 150, mean_len=40), batch=16)
    yield w
    w.close()


@pytest.mark.parametrize("max_postings", [4096, 8])
def test_sharded_server_on_card_matches_host(cuda_device, sharded_warren,
                                             max_postings):
    """The native sharded path on the card and on the host over one
    ShardedWarren: the same addresses, float32 score bits and order."""
    from repro_torch.serve import RetrievalServer
    queries = SHARDED_QUERIES + SHARDED_QUERIES[:3]
    rows = {}
    for name, w, dev in (("card", sharded_warren, cuda_device),
                         ("host", sharded_warren.clone(), "cpu")):
        server = RetrievalServer(w, k=10, max_postings=max_postings,
                                 device=dev)
        try:
            handles = [server.batcher.submit(q) for q in queries]
            rows[name] = [h.get(timeout=60) for h in handles]
        finally:
            server.close()
    assert rows["card"] == rows["host"]
    assert any(rows["card"])


def test_sharded_pipeline_syncs_once_per_batch(cuda_device, sharded_warren):
    """Each group's block is copied from page-locked memory and scored
    without a host sync in between: a batch over three groups makes one
    stream sync (the collection of every group's top-k), read as the
    difference between profiled windows of two batches and of one (the
    profiler's own syncs cancel), and its results are the host's."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import RetrievalServer
    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy")
    server = RetrievalServer(sharded_warren, k=10, device=cuda_device)
    host = RetrievalServer(sharded_warren.clone(), k=10, device="cpu")

    def window(batches):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(batches):
                got = server._handle_sharded(SHARDED_QUERIES)
        names = Counter(e.name for e in prof.events())
        assert names["cudaLaunchKernel"] > 0
        return got, Counter({n: names[n] for n in syncs if names[n]})

    try:
        server._handle_sharded(SHARDED_QUERIES)           # warm-up
        torch.cuda.synchronize()
        got, one = window(1)
        _, two = window(2)
        want = host._handle_sharded(SHARDED_QUERIES)
    finally:
        server.close()
        host.close()
    assert got == want
    assert two - one == Counter({"cudaStreamSynchronize": 1}), (one, two)


# the kernels as operators: the card's fakes, and the FLOP counter on real
# and fake tensors
def _op_args(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    a_s = torch.tensor([1, 5, 9, 12], dtype=torch.int32, device=dev)
    b_s = torch.tensor([0, 4, 11], dtype=torch.int32, device=dev)
    ids = torch.randint(0, 30, (5, 3), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((5, 3), generator=g, device=dev)
    return [
        (gqa_kernel.gqa_decode, (
            torch.randn((2, 2, 3, 64), generator=g, device=dev).bfloat16(),
            torch.randn((2, 300, 2, 64), generator=g, device=dev).bfloat16(),
            torch.randn((2, 300, 2, 64), generator=g, device=dev).bfloat16(),
            torch.tensor([300, 17], dtype=torch.int32, device=dev))),
        (bag_kernel.embedding_bag, (
            torch.randn((30, 8), generator=g, device=dev), ids, w)),
        (bag_kernel.embedding_bag_backward, (
            torch.randn((5, 8), generator=g, device=dev), ids, w, 30)),
        (join_kernel.interval_join_op, (a_s, a_s + 2, b_s, b_s + 3,
                                        "contained_in", None)),
        (kernel.blockmax_scores, (
            torch.rand((3, 4, 8), generator=g, device=dev),
            torch.rand((3, 4), generator=g, device=dev),
            torch.tensor([1.0], device=dev))),
    ]


def test_operators_on_the_card_s_fakes_and_flop_counts(cuda_device):
    """Each operator on CUDA fakes gives the eager output's shape, dtype
    and device without launching, and ``FlopCounterMode`` counts the same
    on the real and the fake call."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    for op, args in _op_args(cuda_device):
        with FlopCounterMode(display=False) as real_count:
            want = op(*args)
        torch.cuda.synchronize()
        with FakeTensorMode() as mode:
            fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
            counts = (gqa_kernel.launches, bag_kernel.launches,
                      bag_kernel.backward_launches, join_kernel.launches,
                      kernel.launches)
            with FlopCounterMode(display=False) as fake_count:
                got = op(*fakes)
            assert counts == (gqa_kernel.launches, bag_kernel.launches,
                              bag_kernel.backward_launches,
                              join_kernel.launches, kernel.launches)
        assert (got.shape, got.dtype, got.device) == (
            want.shape, want.dtype, want.device), op
        assert fake_count.get_total_flops() == \
            real_count.get_total_flops(), op


def test_dry_run_cell_on_the_card_s_fakes_and_for_real(cuda_device):
    """``run_cell`` at DLRM's smoke config on serve_p99: on the card's fakes
    and for real, the same FLOPs and an estimate within the phase's
    rule of the allocator's peak."""
    from repro_torch.launch import dryrun
    cfg = recsys_family.get_config("dlrm-rm2", smoke=True)
    fake = dryrun.run_cell("dlrm-rm2", "serve_p99", cuda_device, cfg)
    real = dryrun.run_cell("dlrm-rm2", "serve_p99", cuda_device, cfg,
                           seed=0)
    assert fake["ok"] and real["ok"], (fake.get("traceback"),
                                       real.get("traceback"))
    assert fake["mesh"] == "cudax1"
    assert fake["cost"]["flops"] == real["cost"]["flops"] > 0
    assert chip_smoke.estimate_holds(
        fake["memory"]["peak_bytes"],
        real["memory"]["allocator_peak_bytes"])
