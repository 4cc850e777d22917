#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:

0. device: the card, its power limit, and the kernel build (set-up time);
1. the bm25_blockmax kernel against its plain version at the small shapes
   of the kernel tests (sweep, empty lists, one element, the θ tie
   boundary, BS off the warp width, k above the positive docs, T = 0);
2. the main path: index 50,000 seeded documents through the port's
   ``ingest_documents``, serve 512 queries from 8 client threads through
   ``RetrievalServer`` on the card, check them against the same server on
   the CPU (bit for bit) and against the float64 host oracle
   ``score_bm25``, and run ``bm25_blockmax_topk`` on the real index for 32
   queries.  Launch counts are zeroed just before and read just after;
3. deployment width: the block-max sweep over the doc space of MS MARCO
   v1 passage (8,841,823 docs, BS = 128, T = 8) with impacts made on the
   card from the seed, timed against its plain version, the one PyTorch
   call computing the unpruned sum, and the card's memory bound; and the
   dense ``bm25_topk`` at the 2^24 accumulator;
4. the kernels line; the last line is ``{"ok": true, "device": ...}``.

It needs a CUDA card and the repository's ``src/`` beside it, and exits
non-zero without a result otherwise.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
N_DOCS = 50_000
N_QUERIES = 512
N_CLIENTS = 8
N_ORACLE = 32
MSMARCO_PASSAGES = 8_841_823
BS = 128
T_DEPLOY = 8
K1, B = 0.9, 0.4
TIMED_LAUNCHES = 30
TIE_RTOL = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- #
# card facts
# --------------------------------------------------------------------- #
def card_peaks(name: str):
    """(memory bytes/s, float32 ops/s, label) from the published data
    sheets, by the name torch reports."""
    if "H200" in name:
        return 4.8e12, 67e12, "H200 SXM: 4.8 TB/s, 67 TFLOP/s fp32"
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe: 2.0 TB/s, 51 TFLOP/s fp32"
    if "H100" in name:
        return 3.35e12, 67e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32"
    raise RuntimeError(f"no published peaks on file for {name!r}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #
def time_cuda(fn, n: int = TIMED_LAUNCHES, flush=None) -> float:
    """Median ms of ``fn()`` over ``n`` runs after 3 warm-ups, each run
    bracketed by its own CUDA events; ``flush()`` (outside the events)
    evicts the L2 cache before every run."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_busy(fn) -> dict:
    """Run ``fn`` under the profiler: wall time, summed device activity
    (kernels and copies) and the top device activities by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [[name[:60], ms] for name, ms in top]}


def kernel_device_ms(fn, kernel_name: str, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of the CUDA kernel ``kernel_name`` per call of
    ``fn`` over ``n`` calls, from the profiler's device events: the
    kernel's own time, without the host's launch path around it.  The
    profiler may drop an event at the window's edge, so the mean is over
    the launches it kept (at least half)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel_name in e.name]
    check(n // 2 <= len(times) <= n, f"profiler saw {len(times)} launches "
                                     f"of {kernel_name}, expected {n}")
    return float(np.mean(times))


def sweep_bound(t: int, nb: int, bs: int, kept: int, bw: float,
                flops: float):
    """(bound_ms, bound_by, bytes) of the pruned sweep: the larger of the
    bytes it must move (block maxima, the kept blocks' impact tiles and the
    output, each once) over the memory rate, and its float32 adds over the
    card's float32 rate."""
    nbytes = 4 * (t * nb + t * bs * kept + nb * bs)
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * (t * nb + t * bs * kept) / flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def max_err(a, b) -> float:
    """max |a - b| over finite entries; raises if the -inf pattern
    differs."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), "kernel and plain version prune different "
                               "blocks")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa] - b[fb]).abs().max())


# --------------------------------------------------------------------- #
# phase 1: kernel vs plain at the kernel tests' shapes
# --------------------------------------------------------------------- #
def small_cases():
    """(name, impacts [T, NB, BS] f32, k), from fixed seeds."""
    cases = []
    for t, nb, bs, k in [(4, 8, 128, 10), (8, 32, 128, 25), (2, 4, 256, 5),
                         (16, 16, 128, 100)]:
        rng = np.random.default_rng(t * 100 + nb)
        imp = rng.random((t, nb, bs), dtype=np.float32)
        imp *= rng.random((t, nb, bs)) < 0.1
        cases.append((f"sweep_{t}x{nb}x{bs}", imp, k))
    cases.append(("empty_lists", np.zeros((2, 4, 128), np.float32), 5))
    one = np.zeros((1, 1, 1), np.float32)
    one[0, 0, 0] = 2.5
    cases.append(("single_element", one, 1))
    tie = np.zeros((1, 4, 8), np.float32)
    tie[0, :, 3] = 1.0
    cases.append(("theta_tie_boundary", tie, 4))
    for t, nb, bs, k in [(1, 1, 100, 3), (3, 5, 100, 7), (2, 3, 7, 4),
                         (3, 2, 1500, 7)]:
        rng = np.random.default_rng(t * 31 + nb)
        imp = rng.random((t, nb, bs), dtype=np.float32)
        imp *= rng.random((t, nb, bs)) < 0.2
        cases.append((f"bs_{t}x{nb}x{bs}", imp.astype(np.float32),
                      min(k, nb * bs)))
    spill = np.zeros((2, 2, 8), np.float32)
    spill[0, 0, 1] = 3.0
    spill[1, 1, 4] = 1.5
    cases.append(("k_exceeds_positive", spill, 10))
    cases.append(("no_terms", np.zeros((0, 4, 128), np.float32), 5))
    cases.append(("k_above_nb_bs", spill[:, :1, :4].copy(), 10))
    return cases


def phase_kernel_small(dev) -> float:
    import torch
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk,
                                                   bm25_topk_ref, ref)
    worst = 0.0
    rows = []
    for name, imp_np, k in small_cases():
        imp = torch.from_numpy(imp_np).to(dev)
        bmax = imp.amax(2)
        thetas = [blockmax_threshold(imp, bmax, k)]
        ub = ref.term_sum(bmax)
        if ub.numel() > 1:          # a mid-range θ prunes some blocks
            thetas.append(ub.median().reshape(1))
        for theta in thetas:
            got = blockmax_scores(imp, bmax, theta)
            want = ref.blockmax_scores(imp, bmax, theta)
            host = ref.blockmax_scores(imp.cpu(), bmax.cpu(), theta.cpu())
            check(torch.equal(got, want), f"{name}: sweep differs from the "
                                          f"plain sweep on the card")
            check(torch.equal(got.cpu(), host), f"{name}: sweep differs "
                                                f"from the plain sweep on "
                                                f"the host")
            worst = max(worst, max_err(got, want))
        got_s, got_i = bm25_blockmax_topk(imp, bmax, k)
        kk = min(k, imp.shape[1] * imp.shape[2])
        want_s, want_i = bm25_topk_ref(imp, kk)
        check(torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-6),
              f"{name}: top-k scores differ")
        check(set(got_i[got_s > 0].tolist()) == set(want_i[want_s > 0]
                                                     .tolist()),
              f"{name}: top-k ids differ")
        check(bool(torch.isfinite(got_s).all()), f"{name}: non-finite "
                                                 f"top-k score")
        rows.append(name)
    torch.cuda.synchronize()
    emit("kernel_small", cases=rows, max_abs_err=worst,
         tolerance="sweep bitwise equal; top-k rtol 1e-5 atol 1e-6, "
                   "id sets of positive scores equal")
    return worst


# --------------------------------------------------------------------- #
# phase 2: the main path
# --------------------------------------------------------------------- #
def make_queries(seed: int, n: int):
    from repro_torch.data.synth import _WORDS
    rng = np.random.default_rng(seed + 1)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(1, 9)),
                                replace=False)) for _ in range(n)]


def agrees_with_oracle(got, oracle_top, oracle_all) -> bool:
    """``got`` [(addr, score32)] vs the float64 oracle: equal top-k score
    multisets at TIE_RTOL, and equal id sets up to ties at the boundary
    (every oracle doc clearly above the k-th score is returned; every
    returned doc scores within TIE_RTOL of the oracle's k-th)."""
    if len(got) != len(oracle_top):
        return False
    if not np.allclose(sorted(s for _, s in got),
                       sorted(s for _, s in oracle_top), rtol=TIE_RTOL,
                       atol=0):
        return False
    if not got:
        return True
    kth = oracle_top[-1][1]
    ids = {a for a, _ in got}
    above = {a for a, s in oracle_top if s > kth * (1 + TIE_RTOL)}
    return above <= ids and all(
        oracle_all.get(a, 0.0) >= kth * (1 - TIE_RTOL) for a in ids)


def serve_closed_loop(server, queries, clients: int):
    """Each of ``clients`` threads sends its share of ``queries`` one at a
    time; returns (results in query order, per-query seconds)."""
    results = [None] * len(queries)
    lat = [0.0] * len(queries)
    errors = []

    def client(c):
        try:
            for i in range(c, len(queries), clients):
                t0 = time.perf_counter()
                results[i] = server.query(queries[i], timeout=120)
                lat[i] = time.perf_counter() - t0
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "a client hung")
    if errors:
        raise errors[0]
    return results, lat


def block_impacts(warren, terms, stats):
    from repro_torch.core import build_block_impacts
    with warren:
        bidx = build_block_impacts(warren, terms, block_size=BS, stats=stats)
    imp = np.zeros((len(bidx.term_blocks), bidx.n_blocks, BS), np.float32)
    for ti, tb in enumerate(bidx.term_blocks):
        imp[ti, tb["di"] // BS, tb["di"] % BS] = tb["imp"]
    return bidx, imp


def phase_main_path(dev, bw, flops, n_docs=N_DOCS, n_queries=N_QUERIES,
                    n_oracle=N_ORACLE):
    import torch
    from repro_torch import obs
    from repro_torch.core import (DynamicIndex, Warren, collection_stats,
                                  ingest_documents, score_bm25)
    from repro_torch.data.synth import doc_generator
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk, kernel,
                                                   pruned_fraction, ref)
    from repro_torch.serve import RetrievalServer

    warren = Warren(DynamicIndex())
    t0 = time.perf_counter()
    ingest_documents(warren, doc_generator(SEED, n_docs), batch=256)
    t_ingest = time.perf_counter() - t0
    emit("ingest", docs=n_docs, seconds=t_ingest,
         host_docs_per_s=n_docs / t_ingest)

    queries = make_queries(SEED, n_queries)
    oracle_q = queries[:n_oracle]
    kernel.launches = 0                 # main path starts here
    server = RetrievalServer(warren, k=10, device=dev)
    try:
        serve_closed_loop(server, queries[:16], N_CLIENTS)     # warm-up
        server.timings.reset()
        obs.registry().reset()
        t0 = time.perf_counter()
        dev_res, lat = serve_closed_loop(server, queries, N_CLIENTS)
        wall = time.perf_counter() - t0
        summary = server.timing_summary()
        busy = device_busy(lambda: serve_closed_loop(
            server, queries[:64], N_CLIENTS))
    finally:
        server.close()
    reg = obs.registry()
    phases = {name: reg.histogram("kernel_phase_ms", kernel="bm25_topk",
                                  phase=name).snapshot()
              for name in ("gather", "compute")}
    batch = reg.histogram("serve_batch_size", lo=0.5, hi=1e4,
                          per_decade=40)
    lat_ms = 1e3 * np.asarray(lat)
    emit("serve", device=str(server.device), queries=n_queries,
         clients=N_CLIENTS, wall_s=wall, qps=n_queries / wall,
         p50_ms=float(np.percentile(lat_ms, 50)),
         p95_ms=float(np.percentile(lat_ms, 95)),
         mean_batch=batch.sum / max(batch.count, 1),
         timing_summary=summary,
         gather_p50_ms=phases["gather"]["p50"],
         compute_p50_ms=phases["compute"]["p50"], traced_64_queries=busy)

    # parity: the same queries scored on the host give the same bits
    cpu_server = RetrievalServer(warren, k=10, device="cpu")
    try:
        handles = [cpu_server.batcher.submit(q) for q in queries]
        cpu_res = [h.get(timeout=120) for h in handles]
    finally:
        cpu_server.close()
    same = sum(a == b for a, b in zip(dev_res, cpu_res))
    check(same == n_queries, f"card and host servers differ on "
                             f"{n_queries - same} of {n_queries} queries")
    emit("parity", queries=n_queries, identical=same)

    # oracle: an uncapped server against float64 score_bm25
    with warren:
        stats = collection_stats(warren)
        oracles = [(score_bm25(warren, q, k=10, stats=stats),
                    dict(score_bm25(warren, q, k=stats.n_docs, stats=stats)))
                   for q in oracle_q]
    exact = RetrievalServer(warren, k=10, max_postings=stats.n_docs,
                            device=dev)
    try:
        handles = [exact.batcher.submit(q) for q in oracle_q]
        got = [h.get(timeout=120) for h in handles]
    finally:
        exact.close()
    ok = sum(agrees_with_oracle(g, top, full)
             for g, (top, full) in zip(got, oracles))
    check(ok == n_oracle, f"server disagrees with score_bm25 on "
                          f"{n_oracle - ok} of {n_oracle} queries")
    emit("oracle", queries=n_oracle, agree=ok,
         tolerance=f"score multisets rtol {TIE_RTOL}, id sets up to ties")

    # the block-max kernel on the real index, as the retrieval example runs
    # it: host block-impact layout, device pruned top-10
    kernel_ok = 0
    impacts_seen = []
    for q, (top, full) in zip(oracle_q, oracles):
        bidx, imp_np = block_impacts(warren, q.split(), stats)
        imp = torch.from_numpy(imp_np).to(dev)
        bmax = imp.amax(2)
        s, i = bm25_blockmax_topk(imp, bmax, k=10)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        res = [(int(bidx.doc_starts[d]), float(v))
               for d, v in zip(i, s) if v > 0]
        kernel_ok += agrees_with_oracle(res, top, full)
        impacts_seen.append((imp, bmax))
    torch.cuda.synchronize()
    launches = kernel.launches          # main path ends here
    check(kernel_ok == n_oracle, f"block-max top-10 disagrees with "
                                 f"score_bm25 on {n_oracle - kernel_ok} "
                                 f"queries")
    check(launches >= n_oracle, f"bm25_blockmax launched {launches} times "
                                f"on the main path, expected >= {n_oracle}")

    # the kernel against its plain version at the main path's shapes
    worst = 0.0
    pruned = []
    for imp, bmax in impacts_seen:
        theta = blockmax_threshold(imp, bmax, 10)
        got_sw = blockmax_scores(imp, bmax, theta)
        want_sw = ref.blockmax_scores(imp, bmax, theta)
        check(torch.equal(got_sw, want_sw), "sweep differs from the plain "
                                            "sweep on the real index")
        worst = max(worst, max_err(got_sw, want_sw))
        pruned.append(float(pruned_fraction(bmax, theta)))
    imp, bmax = max(impacts_seen, key=lambda p: p[0].shape[0])
    theta = blockmax_threshold(imp, bmax, 10)
    kept = int((ref.term_sum(bmax) >= theta).sum())
    emit("kernel_real_index", queries=n_oracle, agree=kernel_ok,
         launches=launches, shapes=sorted({tuple(i.shape)
                                           for i, _ in impacts_seen}),
         mean_pruned_fraction=float(np.mean(pruned)), max_abs_err=worst,
         widest_shape=list(imp.shape),
         widest_call_ms=time_cuda(
             lambda: blockmax_scores(imp, bmax, theta)),
         widest_kernel_device_ms=kernel_device_ms(
             lambda: blockmax_scores(imp, bmax, theta), "bm25_blockmax"),
         widest_plain_ms=time_cuda(
             lambda: ref.blockmax_scores(imp, bmax, theta)),
         widest_bound_ms=sweep_bound(*imp.shape, kept, bw, flops)[0])
    return launches, worst


# --------------------------------------------------------------------- #
# phase 3: deployment width
# --------------------------------------------------------------------- #
def deployment_impacts(dev, n_docs: int, t: int = T_DEPLOY):
    """Seeded BM25 impacts [T, NB, BS] over n_docs documents: per-term df
    log-spaced over 0.05 %..20 % of the docs, geometric tf, normal dl
    (mean 56), the repo's BM25 (k1 = 0.9, b = 0.4)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    nb = -(-n_docs // BS)
    dl = torch.normal(56.0, 25.0, (n_docs,), generator=g, device=dev)
    dl = dl.round().clamp_(min=4.0)
    norm = K1 * (1.0 - B + B * dl / dl.mean())
    impacts = torch.zeros((t, nb * BS), dtype=torch.float32, device=dev)
    dfs = []
    for ti, frac in enumerate(np.geomspace(5e-4, 0.2, t)):
        hit = torch.rand(n_docs, generator=g, device=dev) < float(frac)
        u = torch.rand(n_docs, generator=g, device=dev).clamp_(min=1e-7)
        tf = 1.0 + torch.floor(torch.log(u) / np.log(0.3))
        df = int(hit.sum())
        idf = float(np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)))
        imp = idf * tf * (K1 + 1.0) / (tf + norm)
        impacts[ti, :n_docs] = torch.where(hit, imp, torch.zeros_like(imp))
        dfs.append(df)
    impacts = impacts.view(t, nb, BS)
    return impacts, impacts.amax(2).contiguous(), dfs


def phase_deployment(dev, bw, flops):
    import torch
    from repro_torch.core.vectorized import bm25_topk
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk,
                                                   bm25_topk_ref, ref)
    t0 = time.perf_counter()
    impacts, bmax, dfs = deployment_impacts(dev, MSMARCO_PASSAGES)
    torch.cuda.synchronize()
    t, nb, bs = impacts.shape
    emit("deploy_data", shape=[t, nb, bs], dfs=dfs,
         impacts_mb=impacts.numel() * 4 / 1e6,
         block_max_mb=bmax.numel() * 4 / 1e6,
         output_mb=nb * bs * 4 / 1e6, seconds=time.perf_counter() - t0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ub = ref.term_sum(bmax)
    rows = {}
    worst = 0.0
    for k in (10, 1000):
        theta = blockmax_threshold(impacts, bmax, k)
        kept = int((ub >= theta).sum())
        got = blockmax_scores(impacts, bmax, theta)
        want = ref.blockmax_scores(impacts, bmax, theta)
        check(torch.equal(got, want), f"k={k}: sweep differs from the plain "
                                      f"sweep at deployment width")
        worst = max(worst, max_err(got, want))
        del got, want
        got_s, got_i = bm25_blockmax_topk(impacts, bmax, k)
        want_s, want_i = bm25_topk_ref(impacts, k)
        bitwise = bool(torch.equal(got_s, want_s)
                       and torch.equal(got_i, want_i))
        check(torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
              and set(got_i[got_s > 0].tolist())
              == set(want_i[want_s > 0].tolist()),
              f"k={k}: pruned top-k differs from the exhaustive top-k")
        kernel_ms = time_cuda(lambda: blockmax_scores(impacts, bmax, theta),
                              flush=flush.zero_)
        plain_ms = time_cuda(
            lambda: ref.blockmax_scores(impacts, bmax, theta),
            flush=flush.zero_)
        library_ms = time_cuda(lambda: impacts.sum(0), flush=flush.zero_)
        topk_ms = time_cuda(lambda: bm25_blockmax_topk(impacts, bmax, k),
                            flush=flush.zero_)
        bound_ms, bound_by, nbytes = sweep_bound(t, nb, bs, kept, bw, flops)
        rows[k] = dict(k=k, theta=float(theta), pruned_fraction=1 - kept / nb,
                       blocks_kept=kept, kernel_ms=kernel_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, topk_ms=topk_ms,
                       topk_bitwise_equal_to_exhaustive=bitwise)
        emit("deploy_blockmax", **rows[k])
    del impacts, bmax, flush

    # the dense scorer at the server's accumulator width for this doc space
    q, tt, l = 16, 8, 4096
    n_acc = 1 << (MSMARCO_PASSAGES - 1).bit_length()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    start = torch.randint(0, MSMARCO_PASSAGES, (q, tt, 1), generator=g,
                          device=dev)
    stride = torch.randint(1, MSMARCO_PASSAGES // l, (q, tt, 1),
                           generator=g, device=dev)
    doc_idx = ((start + stride * torch.arange(l, device=dev))
               % MSMARCO_PASSAGES).to(torch.int32)
    imp = torch.rand((q, tt, l), generator=g, device=dev) * 3.0
    qmask = torch.ones((q, tt), device=dev)
    a = bm25_topk(doc_idx, imp, qmask, n_docs=n_acc, k=10)
    b = bm25_topk(doc_idx, imp, qmask, n_docs=n_acc, k=10)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "dense bm25_topk is not deterministic on the card")
    dense_ms = time_cuda(lambda: bm25_topk(doc_idx, imp, qmask,
                                           n_docs=n_acc, k=10), n=10)
    emit("deploy_dense", shape=[q, tt, l], accumulator=n_acc,
         ms=dense_ms, deterministic=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return rows, worst


# --------------------------------------------------------------------- #
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bw, flops, peaks = card_peaks(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = build.build(["bm25_blockmax"], verbose=True)
    build.load("bm25_blockmax")
    emit("device", card=smi, kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, peaks=peaks,
         build_s=time.perf_counter() - t0,
         ptxas={k: v["log"].strip().splitlines()[-3:]
                for k, v in built.items()})

    small_err = phase_kernel_small(dev)
    launches, real_err = phase_main_path(dev, bw, flops)
    rows, deploy_err = phase_deployment(dev, bw, flops)

    r = rows[10]
    print(json.dumps({"kernels": [{
        "name": "bm25_blockmax", "route": "cuda",
        "source": "src/repro_torch/csrc/bm25_blockmax.cu",
        "replaces": "src/repro/kernels/bm25_blockmax/kernel.py:42",
        "launches": launches,
        "max_abs_err": max(small_err, real_err, deploy_err),
        "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "shape": [T_DEPLOY, -(-MSMARCO_PASSAGES // BS), BS], "k": 10,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
