"""Thread-safe metric primitives: Counter, Gauge, log-bucketed Histogram.

Each metric is a single time series; the labeled *families* that group them
("``scatter_latency_ms{group=3}``") live in :mod:`repro_torch.obs.registry`.
Design constraints, in order:

* **Thread safety.**  Every mutation takes the metric's own lock; the
  serving paths hammer these from the ScatterGather pool, the MicroBatcher
  thread, and background compactors at once.  ``snapshot()`` takes the same
  lock, so a snapshot is a consistent point-in-time view of one series.
* **Disabled-mode fast path.**  Every mutator first checks the owning
  registry's ``enabled`` flag and returns before touching the lock — a
  disabled ``inc()``/``observe()`` costs one attribute load and a branch
  (~100 ns), which is what lets instrumentation stay compiled into the hot
  paths permanently instead of being stripped per-deployment.
* **Bounded memory.**  A histogram is a fixed array of log-spaced buckets
  (default: 20 per decade over [1e-3, 1e5], i.e. 1 µs to 100 s for
  millisecond-valued series, ~12 % relative resolution) plus count/sum/
  min/max.  Percentiles are exact up to bucket resolution: ``p95`` returns
  the geometric midpoint of the bucket holding the 95th-percentile sample.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

class _Enabled:
    """Stand-in owner for metrics constructed outside a registry."""

    enabled = True


_ALWAYS = _Enabled()


class Counter:
    """Monotonic counter (no decrements)."""

    kind = "counter"

    def __init__(self, _owner=_ALWAYS):
        self._owner = _owner
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not self._owner.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, _owner=_ALWAYS):
        self._owner = _owner
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._owner.enabled:
            return
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        if not self._owner.enabled:
            return
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Log-bucketed histogram with exact-to-resolution percentiles.

    Bucket ``i`` (1-based) covers ``(lo·10^((i-1)/d), lo·10^(i/d)]`` with
    ``d = per_decade``; bucket 0 is the underflow (v ≤ lo, including zeros
    and negatives) and the last bucket the overflow.  ``percentile(p)``
    walks the cumulative counts and returns the geometric midpoint of the
    bucket where the p-quantile sample lives — within one bucket width
    (~12 % at the default resolution) of the exact order statistic.
    """

    kind = "histogram"
    PERCENTILES = (0.5, 0.95, 0.99)

    def __init__(self, lo: float = 1e-3, hi: float = 1e5,
                 per_decade: int = 20, _owner=_ALWAYS):
        if lo <= 0 or hi <= lo:
            raise ValueError("histogram needs 0 < lo < hi")
        self._owner = _owner
        self._lock = threading.Lock()
        self._lo = lo
        self._log_lo = math.log10(lo)
        self._per_decade = per_decade
        n = int(math.ceil((math.log10(hi) - self._log_lo) * per_decade))
        self._n = n
        self._counts = [0] * (n + 2)     # [0]=underflow, [n+1]=overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self._lo:
            return 0
        i = 1 + int((math.log10(v) - self._log_lo) * self._per_decade)
        return min(i, self._n + 1)

    def _bucket_mid(self, i: int) -> float:
        """Geometric midpoint of bucket i (its representative value)."""
        if i <= 0:
            return self._lo
        if i > self._n:
            return 10 ** (self._log_lo + self._n / self._per_decade)
        return 10 ** (self._log_lo + (i - 0.5) / self._per_decade)

    def observe(self, v: float) -> None:
        if not self._owner.enabled:
            return
        v = float(v)
        b = self._bucket(v)
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Value at quantile ``p`` ∈ [0, 1], exact to bucket resolution;
        NaN when the histogram is empty."""
        with self._lock:
            return self._percentile_locked(p)

    def _bucket_le(self, i: int) -> float:
        """Inclusive upper bound of bucket i (+inf for the overflow)."""
        if i <= 0:
            return self._lo
        if i > self._n:
            return math.inf
        return 10 ** (self._log_lo + i / self._per_decade)

    def _cumulative_buckets_impl(self) -> List[Tuple[str, int]]:
        """Sparse cumulative ``(le, count)`` pairs in Prometheus histogram
        form: ascending upper bounds as strings, count cumulative from the
        underflow bucket up, terminated by ``("+Inf", total)`` (which by
        construction equals ``_count``).  Only buckets that hold samples
        are listed — the exposition stays small however wide the range."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        out: List[Tuple[str, int]] = []
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if c and i <= self._n:
                out.append((format(self._bucket_le(i), ".6g"), cum))
        out.append(("+Inf", total))
        return out
    cumulative_buckets = _cumulative_buckets_impl   # see the _impl note

    # -- windowed reads (delta between two bucket snapshots) ------------- #
    def _bucket_counts_impl(self) -> List[int]:
        """Point-in-time copy of the raw bucket counts.  Pair with
        :meth:`percentile_since` to read *windowed* percentiles out of a
        cumulative histogram: take the counts at window start, then ask
        for the percentile of everything observed since."""
        with self._lock:
            return list(self._counts)
    bucket_counts = _bucket_counts_impl   # see the _impl note

    def _percentile_since_impl(self, prev_counts: Optional[Sequence[int]],
                               p: float) -> float:
        """Percentile over the observations added since ``prev_counts``
        was captured with :meth:`bucket_counts` (``None`` = since the
        beginning).  NaN when the window holds no samples.  Exact to
        bucket resolution, like :meth:`percentile`."""
        with self._lock:
            cur = list(self._counts)
        if prev_counts is None:
            prev_counts = [0] * len(cur)
        if len(prev_counts) != len(cur):
            raise ValueError("bucket snapshot from a different histogram")
        delta = [c - q for c, q in zip(cur, prev_counts)]
        total = sum(delta)
        if total <= 0:
            return math.nan
        target = p * total
        seen = 0
        for i, c in enumerate(delta):
            seen += c
            if seen >= target and c > 0:
                return self._bucket_mid(i)
        return self._bucket_mid(len(delta) - 1)
    percentile_since = _percentile_since_impl   # see the _impl note

    def _over_threshold_since_impl(self, prev_counts: Optional[Sequence[int]],
                                   threshold: float) -> Tuple[int, int]:
        """``(bad, total)`` observation counts since ``prev_counts`` was
        captured with :meth:`bucket_counts` (``None`` = since the
        beginning), where *bad* counts the observations above
        ``threshold`` — the windowed error fraction SLO burn rates are
        built from.  Exact to bucket resolution: a bucket counts as bad
        iff its geometric midpoint exceeds the threshold."""
        with self._lock:
            cur = list(self._counts)
        if prev_counts is None:
            prev_counts = [0] * len(cur)
        if len(prev_counts) != len(cur):
            raise ValueError("bucket snapshot from a different histogram")
        bad = total = 0
        for i, (c, q) in enumerate(zip(cur, prev_counts)):
            d = c - q
            if d <= 0:
                continue
            total += d
            if self._bucket_mid(i) > threshold:
                bad += d
        return bad, total
    over_threshold_since = _over_threshold_since_impl   # see the _impl note

    def _percentile_locked(self, p: float) -> float:
        if self._count == 0:
            return math.nan
        # clamp the percentile's representative to the observed range so
        # tiny samples don't report a bucket midpoint outside [min, max]
        target = p * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target and c:
                mid = self._bucket_mid(i)
                return min(max(mid, self._min), self._max)
        return self._max

    def snapshot(self) -> dict:
        with self._lock:
            out = {"count": self._count, "sum": self._sum,
                   "min": self._min if self._count else math.nan,
                   "max": self._max if self._count else math.nan}
            for p in self.PERCENTILES:
                out[f"p{int(p * 100)}"] = self._percentile_locked(p)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
