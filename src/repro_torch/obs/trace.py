"""Request tracing: contextvar-propagated spans with trace trees.

A :class:`Span` measures one named stage of one request; nesting follows
the *execution* context, not the thread: the active span lives in a
``contextvars.ContextVar``, and :class:`~repro_torch.dist.parallel.ScatterGather`
captures the submitting context per fan-out item, so a span opened inside
a pool worker parents correctly under the span that was active where the
work was *submitted*.  One search through the native sharded server
therefore yields one tree::

    serve.batch
    ├── scatter{group=0}
    │   └── replica_read{group=0, replica=0}
    ├── scatter{group=1}
    │   └── replica_read{group=1, replica=1}
    ├── device_score
    └── merge

Completed traces (a root span plus all its descendants) land in a ring
buffer (:meth:`Tracer.traces`); traces slower than ``slow_ms`` are also
appended as JSON lines to the slow-trace sink — the "what was that p99
spike" artifact.  Span bodies run under ``with``, so an exception closes
the span (flagged ``error``) and still propagates.

Disabled mode returns a shared no-op context manager: one attribute check
and no allocation per ``span()`` call.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .rotate import RotatingJsonl

# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "repro_obs_span", default=None)

_ids = itertools.count(1)
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


class Span:
    """One timed, labeled stage of a trace."""

    __slots__ = ("name", "labels", "trace_id", "span_id", "parent_id",
                 "start_ts", "_t0", "duration_s", "error", "_trace")

    def __init__(self, name: str, labels: Dict[str, object],
                 trace: "_Trace", parent: Optional["Span"]):
        self.name = name
        self.labels = labels
        self.trace_id = trace.trace_id
        self.span_id = _next_id()
        self.parent_id = parent.span_id if parent is not None else None
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.error = False
        self._trace = trace

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.duration_s is None else 1e3 * self.duration_s

    def to_record(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "start_ts": self.start_ts,
                "duration_ms": self.duration_ms, "error": self.error}


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

    def _tree_impl(self) -> dict:
        """Nested dict form: {name, labels, duration_ms, children}."""
        with self._lock:
            spans = list(self.spans)
        children: Dict[Optional[int], List[Span]] = {}
        for s in spans:
            children.setdefault(s.parent_id, []).append(s)

        def node(s: Span) -> dict:
            kids = sorted(children.get(s.span_id, ()),
                          key=lambda c: c.start_ts)
            return {"name": s.name, "labels": dict(s.labels),
                    "duration_ms": s.duration_ms, "error": s.error,
                    "children": [node(c) for c in kids]}

        return node(self.root) if self.root is not None else {}
    tree = _tree_impl   # see the _impl note

    def names(self) -> List[str]:
        with self._lock:
            return [s.name for s in self.spans]

    @property
    def duration_ms(self) -> Optional[float]:
        return self.root.duration_ms if self.root is not None else None

    def to_record(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        return {"trace_id": self.trace_id,
                "root": self.root.name if self.root else None,
                "duration_ms": self.duration_ms,
                "spans": [s.to_record() for s in spans]}


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
            # label the span with the exception type so errored spans are
            # greppable in dumps and visible in /traces; the exception
            # still propagates (we never swallow it)
            span.labels.setdefault("error", exc_type.__name__)
        _CURRENT.reset(self._token)
        if span.parent_id is None:           # root closed: trace complete
            self._tracer._finish(span._trace)
        return False


class Tracer:
    """Ring-buffer retention of completed traces + slow-trace JSONL dump."""

    def __init__(self, capacity: int = 128, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: "deque[_Trace]" = deque(maxlen=capacity)
        self._slow_ms: Optional[float] = None
        self._slow_sink: Optional[RotatingJsonl] = None
        self.n_slow_dumped = 0

    # -- span creation ----------------------------------------------------- #
    def span(self, name: str, **labels):
        """Open a span under the execution-context's active span (or start
        a new trace).  Use as ``with tracer.span("merge", group=g):``."""
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, labels)

    def current(self) -> Optional[Span]:
        return _CURRENT.get()

    # -- retention --------------------------------------------------------- #
    def _finish(self, trace: _Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            slow_ms, sink = self._slow_ms, self._slow_sink
        # errored traces are always dump-eligible: a request that died is
        # at least as interesting as one that was merely slow
        errored = trace.root is not None and trace.root.error
        if (slow_ms is not None
                and ((trace.duration_ms or 0.0) >= slow_ms or errored)):
            rec = json.dumps(trace.to_record(), sort_keys=True)
            with self._lock:
                self.n_slow_dumped += 1
            if sink is not None:
                sink.write_line(rec)

    def traces(self) -> List[_Trace]:
        """Completed traces, oldest first (up to ring capacity)."""
        with self._lock:
            return list(self._ring)

    def last_trace(self, root: Optional[str] = None) -> Optional[_Trace]:
        """Most recent completed trace, optionally matching a root name."""
        with self._lock:
            ring = list(self._ring)
        for t in reversed(ring):
            if root is None or (t.root is not None and t.root.name == root):
                return t
        return None

    def _trace_by_id_impl(self, trace_id: int) -> Optional[_Trace]:
        """Completed trace with the given id, if still in the ring."""
        with self._lock:
            ring = list(self._ring)
        for t in reversed(ring):
            if t.trace_id == trace_id:
                return t
        return None
    trace_by_id = _trace_by_id_impl   # see the _impl note

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.n_slow_dumped = 0

    # -- slow-trace dump ---------------------------------------------------- #
    def set_slow_dump(self, threshold_ms: Optional[float],
                      path: Optional[str] = None,
                      max_bytes: int = 4 << 20, backups: int = 2) -> None:
        """Dump every trace slower than ``threshold_ms`` — and every
        errored trace, regardless of duration — as one JSON line appended
        to ``path`` (None threshold disables; None path counts slow
        traces without writing).  The dump is size-capped: it rotates at
        ``max_bytes`` keeping ``backups`` old files, so a server that
        runs for days cannot fill the disk with its own telemetry."""
        with self._lock:
            self._slow_ms = threshold_ms
            self._slow_sink = (RotatingJsonl(path, max_bytes=max_bytes,
                                             backups=backups)
                               if path is not None else None)


# -- process-global tracer -------------------------------------------------- #
_GLOBAL = Tracer()


def tracer() -> Tracer:
    return _GLOBAL


def span(name: str, **labels):
    """``with repro_torch.obs.span("scatter", group=3): ...`` on the global
    tracer."""
    return _GLOBAL.span(name, **labels)
