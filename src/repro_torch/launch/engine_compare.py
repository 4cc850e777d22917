"""Query engines compared: the two hot query paths, each three ways.

    python -m repro_torch.launch.engine_compare [--device cpu]
        [--sizes 1000 10000 100000] [--docs 200000] [--postings 20000]

(a) Structural containment join A ⊲ B (|B| = |A|/10): the lazy host GCL
engine, the plain vectorized mask (``torch.searchsorted``) and the
``interval_join`` kernel.  (b) BM25 top-10: numpy on the host, the dense
scatter-add ``bm25_topk`` and the block-max ``bm25_blockmax_topk``.  Every
row checks that the three agree.

It runs on the card unless given ``--device cpu``, and raises without a
card.  On the CPU the kernel wrappers take their plain versions, so the
kernel columns time those.  Times are host wall clock around work that
ends in a device synchronise, averaged over ``--repeats`` after one
warm-up call.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core import gcl
from repro_torch.core.annotation import reduce_minimal
from repro_torch.core.vectorized import bm25_topk, pack
from repro_torch.device import resolve_device
from repro_torch.kernels import bm25_blockmax_topk, interval_join
from repro_torch.kernels.interval_join import contained_in_mask_ref


def random_gc(rng, n, span):
    s = np.sort(rng.choice(span, size=min(n, span), replace=False))
    e = s + rng.integers(0, 30, size=len(s))
    return reduce_minimal(s, e, np.zeros(len(s)))


def _timed(fn: Callable, device: torch.device, repeats: int):
    """(last result, mean seconds per call) after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) / repeats


def bench_joins(sizes=(1000, 10_000, 100_000), device=None,
                repeats: int = 5) -> List[dict]:
    device = resolve_device(device)
    print(f"## containment join A ⊲ B (|B| = |A|/10), device {device}")
    print(f"{'|A|':>9s} {'lazy host':>12s} {'plain':>12s} "
          f"{'interval_join':>14s}")
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        A = random_gc(rng, n, n * 20)
        B = random_gc(rng, max(n // 10, 1), n * 20)
        t0 = time.perf_counter()
        lazy = gcl.ContainedIn(gcl.Term(A), gcl.Term(B)).solutions()
        t_lazy = time.perf_counter() - t0

        a_s, a_e, _ = pack(A.starts, A.ends, device=device)
        b_s, b_e, _ = pack(B.starts, B.ends, device=device)
        plain, t_plain = _timed(
            lambda: contained_in_mask_ref(a_s, a_e, b_s, b_e), device,
            repeats)
        mask, t_kernel = _timed(lambda: interval_join(a_s, a_e, b_s, b_e),
                                device, repeats)
        if not torch.equal(mask, plain):
            raise AssertionError(f"|A|={n}: kernel and plain masks differ")
        hits = np.flatnonzero(mask.cpu().numpy()[:len(A)])
        got = [(int(A.starts[i]), int(A.ends[i])) for i in hits]
        if got != [(p, q) for p, q, _ in lazy]:
            raise AssertionError(f"|A|={n}: mask disagrees with the lazy "
                                 f"engine")
        rows.append({"n": n, "matches": len(lazy), "lazy_ms": 1e3 * t_lazy,
                     "plain_ms": 1e3 * t_plain, "kernel_ms": 1e3 * t_kernel})
        print(f"{n:9d} {1e3 * t_lazy:10.2f}ms {1e3 * t_plain:10.2f}ms "
              f"{1e3 * t_kernel:12.2f}ms")
    return rows


def bench_bm25(n_docs: int = 200_000, n_terms: int = 4,
               postings: int = 20_000, device=None, repeats: int = 3,
               block_size: int = 256) -> dict:
    device = resolve_device(device)
    print(f"\n## BM25 top-10, {n_docs} docs, {n_terms} terms × {postings} "
          f"postings, device {device}")
    rng = np.random.default_rng(1)
    doc_idx = np.stack([np.sort(rng.choice(n_docs, size=postings,
                                           replace=False))
                        for _ in range(n_terms)]).astype(np.int32)
    impacts = rng.random((n_terms, postings)).astype(np.float32) * 3

    def host():
        acc = np.zeros(n_docs, np.float32)
        for t in range(n_terms):
            np.add.at(acc, doc_idx[t], impacts[t])
        return acc

    acc, t_host = _timed(host, torch.device("cpu"), repeats)

    di = torch.from_numpy(doc_idx)[None].to(device)
    im = torch.from_numpy(impacts)[None].to(device)
    qm = torch.ones((1, n_terms), dtype=torch.float32, device=device)
    (s, _), t_dense = _timed(lambda: bm25_topk(di, im, qm, n_docs=n_docs,
                                               k=10), device, repeats)

    nb = -(-n_docs // block_size)
    blocked = np.zeros((n_terms, nb, block_size), np.float32)
    blocked[np.arange(n_terms)[:, None], doc_idx // block_size,
            doc_idx % block_size] = impacts
    jb = torch.from_numpy(blocked).to(device)
    jm = jb.amax(2)
    (s2, _), t_kernel = _timed(lambda: bm25_blockmax_topk(jb, jm, k=10),
                               device, repeats)

    want = np.sort(acc)[::-1][:10]
    for name, got in (("dense", s[0]), ("block-max", s2)):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                   err_msg=f"{name} top-10 scores")
    print(f"host numpy        {1e3 * t_host:10.2f}ms")
    print(f"dense bm25_topk   {1e3 * t_dense:10.2f}ms")
    print(f"bm25_blockmax     {1e3 * t_kernel:10.2f}ms")
    return {"host_ms": 1e3 * t_host, "dense_ms": 1e3 * t_dense,
            "blockmax_ms": 1e3 * t_kernel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[1000, 10_000, 100_000],
                    help="|A| of each containment join")
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--postings", type=int, default=20_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    bench_joins(args.sizes, device, args.repeats)
    bench_bm25(args.docs, postings=args.postings, device=device,
               repeats=args.repeats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
