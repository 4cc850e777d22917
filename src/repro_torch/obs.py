"""Minimal telemetry plane: metrics registry, request spans, profiled locks.

A stdlib-only subset of the reference telemetry plane, with the same metric,
span and lock-profile names, so dashboards and the static analyzer read the
port exactly as they read the original:

* metrics: thread-safe :class:`Counter` / :class:`Gauge` / log-bucketed
  :class:`Histogram` in a process-global :func:`registry` of labeled
  families.  Every mutator first checks the owning registry's ``enabled``
  flag, so a disabled registry turns instrumentation into no-ops.
* tracing: contextvar-propagated :func:`span` trees; completed traces land
  in a ring buffer (:meth:`Tracer.traces`).
* profiling: :class:`ProfiledLock` times *contended* acquires into
  ``lock_wait_ms{lock}``; :func:`phase_timer` attributes wall time to
  ``kernel_phase_ms{kernel,phase}`` (``gather`` = host pack, ``compute`` =
  device dispatch + copy back).
"""

from __future__ import annotations

import contextvars
import itertools
import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


# --------------------------------------------------------------------- #
# metric primitives
# --------------------------------------------------------------------- #
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

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Log-bucketed histogram with exact-to-resolution percentiles.

    Bucket ``i`` (1-based) covers ``(lo·10^((i-1)/d), lo·10^(i/d)]`` with
    ``d = per_decade``; bucket 0 is the underflow and the last bucket the
    overflow.  ``snapshot()`` reports p50/p95/p99 as the geometric midpoint
    of the bucket holding that sample, clamped to the observed range.
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
        self._n = int(math.ceil((math.log10(hi) - self._log_lo) * per_decade))
        self._counts = [0] * (self._n + 2)
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
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _percentile_locked(self, p: float) -> float:
        if self._count == 0:
            return math.nan
        target = p * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target and c:
                return min(max(self._bucket_mid(i), self._min), self._max)
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


# --------------------------------------------------------------------- #
# registry of labeled families
# --------------------------------------------------------------------- #
LabelKey = Tuple[Tuple[str, str], ...]


class _Family:
    __slots__ = ("kind", "help", "children")

    def __init__(self, kind: str, help: str):
        self.kind = kind
        self.help = help
        self.children: Dict[LabelKey, object] = {}


class MetricsRegistry:
    """Process-wide collection of labeled metric families."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def reset(self) -> None:
        """Zero every series (families and label sets survive)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for m in list(fam.children.values()):
                m.reset()

    def _metric(self, cls, name: str, help: str, labels: dict, **kw):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(cls.kind, help)
            elif fam.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} is a {fam.kind}, not a {cls.kind}")
            m = fam.children.get(key)
            if m is None:
                m = fam.children[key] = cls(_owner=self, **kw)
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._metric(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._metric(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", lo: float = 1e-3,
                  hi: float = 1e5, per_decade: int = 20,
                  **labels) -> Histogram:
        return self._metric(Histogram, name, help, labels,
                            lo=lo, hi=hi, per_decade=per_decade)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem reports into."""
    return _REGISTRY


# --------------------------------------------------------------------- #
# request tracing
# --------------------------------------------------------------------- #
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_torch_obs_span", default=None)

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class Span:
    """One timed, labeled stage of a trace."""

    __slots__ = ("name", "labels", "trace_id", "span_id", "parent_id",
                 "_t0", "duration_s", "error", "_trace")

    def __init__(self, name: str, labels: Dict[str, object],
                 trace: "_Trace", parent: Optional["Span"]):
        self.name = name
        self.labels = labels
        self.trace_id = trace.trace_id
        self.span_id = _next_id()
        self.parent_id = parent.span_id if parent is not None else None
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.error = False
        self._trace = trace


class _Trace:
    """All spans of one request, collected across threads."""

    __slots__ = ("trace_id", "root", "_lock", "spans")

    def __init__(self):
        self.trace_id = _next_id()
        self.root: Optional[Span] = None
        self._lock = threading.Lock()
        self.spans: List[Span] = []

    def add(self, span: Span) -> None:
        with self._lock:
            if self.root is None:
                self.root = span
            self.spans.append(span)

    def names(self) -> List[str]:
        with self._lock:
            return [s.name for s in self.spans]


class _NullSpanCtx:
    """Shared no-op for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpanCtx()


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_labels", "_span", "_token")

    def __init__(self, tracer: "Tracer", name: str, labels: dict):
        self._tracer = tracer
        self._name = name
        self._labels = labels

    def __enter__(self) -> Span:
        parent = _CURRENT.get()
        trace = parent._trace if parent is not None else _Trace()
        self._span = Span(self._name, self._labels, trace, parent)
        trace.add(self._span)
        self._token = _CURRENT.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self._span
        span.duration_s = time.perf_counter() - span._t0
        span.error = exc_type is not None
        if exc_type is not None:
            span.labels.setdefault("error", exc_type.__name__)
        _CURRENT.reset(self._token)
        if span.parent_id is None:           # root closed: trace complete
            self._tracer._finish(span._trace)
        return False


class Tracer:
    """Ring-buffer retention of completed traces."""

    def __init__(self, capacity: int = 128, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: "deque[_Trace]" = deque(maxlen=capacity)

    def span(self, name: str, **labels):
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, labels)

    def _finish(self, trace: _Trace) -> None:
        with self._lock:
            self._ring.append(trace)

    def traces(self) -> List[_Trace]:
        """Completed traces, oldest first (up to ring capacity)."""
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def span(name: str, **labels):
    """``with obs.span("merge"): ...`` on the global tracer."""
    return _TRACER.span(name, **labels)


# --------------------------------------------------------------------- #
# profiling
# --------------------------------------------------------------------- #
class ProfiledLock:
    """A Lock/RLock wrapper that histograms *contended* wait time.

    The fast path tries a non-blocking acquire first, so uncontended use
    never touches the metrics plane; a blocking acquire is timed into
    ``lock_wait_ms{lock=<name>}`` and counted in
    ``lock_contended_total{lock=<name>}``.  Wrapping an ``RLock`` keeps
    reentrancy.
    """

    def __init__(self, name: str, lock=None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()
        reg = registry()
        self._wait = reg.histogram(
            "lock_wait_ms",
            "time spent blocked on a contended hot lock", lock=name)
        self._contended = reg.counter(
            "lock_contended_total",
            "acquires that had to block", lock=name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        self._wait.observe(1e3 * (time.perf_counter() - t0))
        self._contended.inc()
        return ok

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "ProfiledLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


@contextmanager
def phase_timer(kernel: str, phase: str):
    """Attribute a block's wall time to one kernel phase:
    ``kernel_phase_ms{kernel,phase}``.  Phases by convention: ``gather``
    (host-side packing) and ``compute`` (device dispatch + copy back)."""
    reg = registry()
    if not reg.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.histogram(
            "kernel_phase_ms",
            "device-kernel wall time by phase (gather=host pack, "
            "compute=dispatch+copy back)",
            kernel=kernel, phase=phase,
        ).observe(1e3 * (time.perf_counter() - t0))
