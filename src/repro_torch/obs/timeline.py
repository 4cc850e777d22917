"""Spans on a device trace's clock: device time and device idle time put
down to the span that launched or waited.

``torch.profiler`` stamps its events on its own clock (µs from the
trace's start); spans read :func:`repro_torch.obs.trace.now_ns`.  The two
are tied once per profiled window: :func:`sync_mark` reads the span clock
just before and just after each of a few ``torch.cuda.synchronize()``
calls, which the profiler records as ``cudaDeviceSynchronize`` calls, and
:func:`clock_offset_ns` puts the middle of the call that the readings
hold tightest on the middle of its two readings (the first runtime call
of a profiled window can take a millisecond of host time more than its
event shows, while the profiler sets up its buffers).  Take the mark
first inside the window, before any other synchronise::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        mark = timeline.sync_mark()
        run()                                  # with tracing on
        torch.cuda.synchronize()
    events = timeline.from_profiler(p.events())
    out = timeline.attribute(events, spans,
                             timeline.clock_offset_ns(events, mark))

:func:`attribute` gives each device operation to the innermost span whose
interval holds the runtime call that launched it, matched by the
profiler's correlation id (never by order), and each idle gap of the
device to the innermost span the host was in at the gap's middle.  The
profiler's device timestamps can sit hundreds of µs off its host ones
(0-430 µs by profiled window on an H100); :func:`device_skew_ns` takes that
shift out first, from the fastest launch of the window.  A
span is named by its path from its trace's root (``lm.decode_step/
lm.attention/lm.gqa_decode``); work outside every span is ``outside``.
The spans are those of one thread (nested, as a thread's spans are).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Tuple

from .trace import now_ns

OUTSIDE = "outside"
SYNC_CALL = "cudaDeviceSynchronize"


class Event(NamedTuple):
    """One profiler event on the profiler's clock: a device operation
    (kernel, copy, fill) or a host runtime call."""
    corr: int                # the profiler's correlation id
    name: str
    start_ns: int
    end_ns: int
    on_device: bool


def from_profiler(events) -> List[Event]:
    """``torch.profiler`` events (``prof.events()``) as :class:`Event`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.id, e.name, round(1e3 * e.time_range.start),
                  round(1e3 * e.time_range.end), e.device_type == cuda)
            for e in events]


def sync_mark(n: int = 4) -> List[Tuple[int, int]]:
    """The span clock just before and just after each of ``n``
    ``torch.cuda.synchronize()`` calls in a row."""
    import torch
    out = []
    for _ in range(n):
        before = now_ns()
        torch.cuda.synchronize()
        out.append((before, now_ns()))
    return out


def clock_offset_ns(events: Iterable[Event], mark: List[Tuple[int, int]],
                    call: str = SYNC_CALL) -> Tuple[int, int]:
    """(offset, error): a time ``t`` of the span clock is ``t + offset``
    on the profiler's, within ``error`` ns either way.  ``mark`` is
    :func:`sync_mark`'s, whose calls are the window's first ``call``
    events, in order."""
    first = sorted((e for e in events if not e.on_device and e.name == call),
                   key=lambda e: e.start_ns)[:len(mark)]
    if len(first) < len(mark):
        raise ValueError(f"the trace holds {len(first)} {call} calls, the "
                         f"mark {len(mark)}")
    best = None
    for e, (before, after) in zip(first, mark):
        slack = (after - before) - (e.end_ns - e.start_ns)
        if slack < 0:
            raise ValueError(f"a {call} call outlasts the readings around "
                             f"it: not the mark's call")
        if best is None or slack < best[1]:
            best = ((e.start_ns + e.end_ns - before - after) // 2, slack)
    return best[0], best[1] // 2 + 1


def device_skew_ns(events: Iterable[Event]) -> int:
    """How far the profiler's device clock reads ahead of its host clock:
    the least time from a runtime call's start to the start of a device
    operation it launched (no operation starts before its launch is
    called; the fastest launch of a window, onto an idle device, takes a
    few µs)."""
    calls = {e.corr: e.start_ns for e in events
             if not e.on_device and e.corr > 0}
    return min((e.start_ns - calls[e.corr] for e in events
                if e.on_device and e.corr in calls), default=0)


def _paths(spans) -> Dict[int, str]:
    """Each span's path from its trace's root, by ``span_id``."""
    by_id = {s.span_id: s for s in spans}
    out: Dict[int, str] = {}

    def path(s) -> str:
        if s.span_id not in out:
            parent = by_id.get(s.parent_id)
            out[s.span_id] = (s.name if parent is None
                              else path(parent) + "/" + s.name)
        return out[s.span_id]
    for s in spans:
        path(s)
    return out


class _Innermost:
    """The innermost span open at a time of the span clock: the nested
    spans cut into segments, each with the path of the span that holds
    it (or ``outside``)."""

    def __init__(self, spans):
        spans = [s for s in spans if s.end_ns is not None]
        paths = _paths(spans)
        self.bounds: List[int] = []
        self.labels: List[str] = []
        stack: list = []

        def mark(t: int) -> None:
            label = paths[stack[-1].span_id] if stack else OUTSIDE
            if self.bounds and self.bounds[-1] == t:
                self.labels[-1] = label
            else:
                self.bounds.append(t)
                self.labels.append(label)
        for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
            while stack and stack[-1].end_ns <= s.start_ns:
                t = stack.pop().end_ns
                mark(t)
            stack.append(s)
            mark(s.start_ns)
        while stack:
            t = stack.pop().end_ns
            mark(t)

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.labels[i] if i >= 0 else OUTSIDE


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def attribute(events: Iterable[Event], spans, offset: Tuple[int, int]
              ) -> dict:
    """Device seconds, idle seconds and launching runtime calls by the
    path of the innermost span (``outside`` where none was open), from a
    profiled window's ``events`` and the ``spans`` of the same window
    (:class:`~repro_torch.obs.trace.Span`: ``name``, ``span_id``,
    ``parent_id``, ``start_ns``, ``end_ns``); ``offset`` is
    :func:`clock_offset_ns`'s.  Device times are read less
    :func:`device_skew_ns` (``device_skew_ns`` in the result).

    ``launches`` counts the runtime calls that launched at least one
    device operation of the window; ``ops_unmatched`` the device
    operations whose launching call the trace lacks (their time is under
    ``unmatched``), ``calls_without_op`` the runtime launch calls (a name
    with ``Launch``) with no device operation in the trace."""
    events = list(events)
    skew = device_skew_ns(events)
    device = [e._replace(start_ns=e.start_ns - skew, end_ns=e.end_ns - skew)
              for e in events if e.on_device]
    if not device:
        raise ValueError("the trace holds no device operation")
    host = [e for e in events if not e.on_device]
    calls = {e.corr: e for e in host if e.corr > 0}
    events = device + host
    inner = _Innermost(spans)
    shift = offset[0]
    device_s: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    launched = set()
    unmatched = 0
    for op in device:
        call = calls.get(op.corr)
        if call is None:
            unmatched += 1
            label = "unmatched"
        else:
            label = inner.at(call.start_ns - shift)
            if op.corr not in launched:
                launched.add(op.corr)
                launches[label] += 1
        device_s[label] += (op.end_ns - op.start_ns) / 1e9
    lo = min(e.start_ns for e in events)
    hi = max(e.end_ns for e in events)
    busy = _union([(e.start_ns, e.end_ns) for e in device])
    idle_s: Dict[str, float] = defaultdict(float)
    prev = lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            idle_s[inner.at((prev + a) // 2 - shift)] += (a - prev) / 1e9
        prev = max(prev, b)
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_s": dict(device_s), "idle_s": dict(idle_s),
            "launches": dict(launches), "ops_unmatched": unmatched,
            "calls_without_op": sum(
                1 for c in calls.values()
                if "Launch" in c.name and c.corr not in launched),
            "clock_error_ns": offset[1], "device_skew_ns": skew}

