"""Scatter-gather execution for sharded serving and background migration.

Semantics.  :class:`ScatterGather` is a small worker pool that fans
per-group read closures out concurrently and gathers results in input
order.  It is the engine behind ``ShardedWarren``'s async scatter:
``annotations``, ``global_stats``, ``search`` (both scatter phases) and
``search_gcl`` hand it one closure per shard group instead of looping on
the caller thread.  Each closure runs the group's full replica-failover
protocol (``_group_read``) inside the worker, so a replica dying
mid-scatter fails over exactly as it would on the sequential path —
workers touch disjoint per-group state, which is what makes the fan-out
safe.  The same ``map`` fan-out hosts a live shard migration's bulk
segment streaming (``repro_torch.dist.rebalance``), so rebalancing work runs on
pool workers rather than a serving thread.

Failure model and invariants:

* **Run-all-then-raise.**  ``run``/``map`` let every closure finish before
  re-raising the *first* failure in input order — per-group side effects
  (failover marks, read-warren re-pins) are never torn mid-scatter, and a
  caller observing an exception knows every group reached a settled state.
* **Caller participation.**  The caller thread executes the first closure
  itself: a fan-out never leaves the caller idle, costs one fewer wakeup,
  and a 1-item scatter degrades to a plain call.
* **Close is graceful, not fatal.**  A closed pool (or a ``close`` racing
  a fan-out) degrades to the caller-thread loop — holders never need to
  guard fan-outs on pool lifetime, and no submitted work is dropped.
* **No ordering between items.**  Closures of one fan-out may run in any
  order and concurrently; correctness must come from the closures touching
  disjoint state (per-group reads do; anything else must lock).

:class:`ScatterTimings` is the thread-safe scatter/score/merge time
accumulator the serving paths report their per-query breakdown through.
"""

from __future__ import annotations

import contextvars
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.obs import registry


class ScatterTimings:
    """Thread-safe accumulator for the serving-path time breakdown.

    ``scatter``  fan-out reads (per-group stats + annotation lists)
    ``score``    per-group packing + device/host scoring
    ``merge``    the global k-way merge of per-group top-k lists

    Every ``add`` also feeds the per-query breakdown into the obs
    histograms (``serve_{scatter,score,merge}_latency_ms{site=...}``),
    which carry the percentiles; the struct itself keeps only running
    sums for its human-readable ``summary``.  Because one instance is
    shared across every clone of a warren (via ``_ctx``), the sums are
    *windowed*: ``window()`` returns the delta since the last call and
    bumps ``epoch``, so long-lived servers report per-window rates
    instead of lifetime averages.
    """

    def __init__(self, site: str = "warren.search"):
        self._lock = threading.Lock()
        self.site = site
        self.epoch = 0
        self.scatter_s = 0.0
        self.score_s = 0.0
        self.merge_s = 0.0
        self.queries = 0
        reg = registry()
        self._h_scatter = reg.histogram(
            "serve_scatter_latency_ms",
            "per-query scatter (fan-out read) time", site=site)
        self._h_score = reg.histogram(
            "serve_score_latency_ms",
            "per-query pack + device/host scoring time", site=site)
        self._h_merge = reg.histogram(
            "serve_merge_latency_ms",
            "per-query global k-way merge time", site=site)

    def reset(self) -> None:
        """Zero the window sums and bump the epoch marker."""
        with self._lock:
            self.scatter_s = self.score_s = self.merge_s = 0.0
            self.queries = 0
            self.epoch += 1

    def add(self, scatter: float = 0.0, score: float = 0.0,
            merge: float = 0.0, queries: int = 1) -> None:
        with self._lock:
            self.scatter_s += scatter
            self.score_s += score
            self.merge_s += merge
            self.queries += queries
        self._h_scatter.observe(1e3 * scatter)
        self._h_score.observe(1e3 * score)
        self._h_merge.observe(1e3 * merge)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"scatter_s": self.scatter_s, "score_s": self.score_s,
                    "merge_s": self.merge_s, "queries": self.queries,
                    "epoch": self.epoch}

    def window(self) -> Dict[str, float]:
        """Snapshot the current window, then reset it (epoch += 1)."""
        with self._lock:
            out = {"scatter_s": self.scatter_s, "score_s": self.score_s,
                   "merge_s": self.merge_s, "queries": self.queries,
                   "epoch": self.epoch}
            self.scatter_s = self.score_s = self.merge_s = 0.0
            self.queries = 0
            self.epoch += 1
        return out

    def summary(self) -> str:
        s = self.snapshot()
        q = max(s["queries"], 1)
        total = s["scatter_s"] + s["score_s"] + s["merge_s"]
        return (f"{s['queries']} queries — scatter "
                f"{1e3 * s['scatter_s'] / q:.2f} score "
                f"{1e3 * s['score_s'] / q:.2f} merge "
                f"{1e3 * s['merge_s'] / q:.2f} ms/query "
                f"(total {1e3 * total / q:.2f})")


class ScatterGather:
    """Worker pool for ordered per-group fan-out.

    A closed (or single-item) scatter degrades to the caller-thread loop,
    so holders never have to guard their fan-outs on pool lifetime.  The
    pool is elastic: ``resize`` swaps in a new worker width on a live pool
    (the autopilot drives this as the group count changes) without
    dropping or blocking in-flight fan-outs.
    """

    def __init__(self, workers: Optional[int] = None):
        self.workers = workers if workers else min(16, os.cpu_count() or 4)
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="scatter")
        self._lifecycle = threading.Lock()   # serializes resize/close
        self._closed = False

    def resize(self, workers: int) -> None:
        """Grow or shrink the worker count on a LIVE pool.

        A fresh executor with the new width is published first and the old
        one is retired with ``shutdown(wait=False)`` — already-submitted
        work keeps running on the old threads until done, so in-flight
        fan-outs always complete; only *new* fan-outs land on the new
        width.  A ``run`` that raced the swap and submitted into the
        retired executor falls back to running those thunks inline (the
        same degrade path ``close`` uses).  No-op when the requested width
        matches or the pool is closed.
        """
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        with self._lifecycle:
            if self._closed or workers == self.workers:
                return
            old = self._pool
            self._pool = ThreadPoolExecutor(max_workers=workers,
                                            thread_name_prefix="scatter")
            self.workers = workers
            old.shutdown(wait=False)
        reg = registry()
        if reg.enabled:
            reg.gauge("scatter_pool_workers",
                      "current ScatterGather worker count").set(workers)

    def run(self, thunks: Sequence[Callable[[], Any]]) -> List[Any]:
        """Run thunks concurrently; results in input order.

        The caller thread participates (it runs the first thunk itself
        while workers take the rest), so a fan-out never leaves the caller
        idle and costs one fewer wakeup.  Every thunk runs to completion
        before the first exception (in input order) is re-raised, so
        per-group side effects — failover marks, read-warren swaps — are
        never torn mid-scatter.
        """
        if self._closed or len(thunks) <= 1:
            return [t() for t in thunks]
        futures = []
        for t in thunks[1:]:
            # One context copy per thunk: trace spans opened inside the
            # worker parent under the span active at submission, and a
            # Context can only run one callable at a time.
            ctx = contextvars.copy_context()
            try:
                futures.append(self._pool.submit(ctx.run, t))
            except RuntimeError:          # close() raced the fan-out: the
                futures.append(t)         # unsubmitted tail runs inline
        first: Optional[BaseException] = None
        try:
            head = thunks[0]()
        except BaseException as e:
            first, head = e, None
        out: List[Any] = [head]
        for f in futures:
            try:
                out.append(f() if callable(f) else f.result())
            except BaseException as e:
                if first is None:
                    first = e
                out.append(None)
        if first is not None:
            raise first
        return out

    def map(self, fn: Callable[[Any], Any], items: Sequence[Any]) -> List[Any]:
        return self.run([lambda it=it: fn(it) for it in items])

    def close(self) -> None:
        with self._lifecycle:
            self._closed = True
            self._pool.shutdown(wait=False)

    def __enter__(self) -> "ScatterGather":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
