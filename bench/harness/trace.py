"""Host spans and the device trace of a traced sub-window.

:class:`Spans` times the benchmark's own calls into each layer of the
program by the host's clock (``step``, ``argmax_copy``, ``refill``,
``prefill_call``).  :func:`profiled` runs a function under
``torch.profiler`` with CUDA activity alone (recording every CPU
operator too slowed an InternLM2-1.8B decode step on an H100 from 36 to
43-48 ms, CUDA activity alone cost about 4 ms) and reduces the timeline
to the device's busy time, the idle gaps by the CUDA runtime call the
host was in (or ``host`` between calls), the device operations by total
time and every kernel's durations by name.  The traced window runs from
the first to the last event on the timeline.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

TOP = 10                 # entries of each breakdown list


class Spans:
    """Durations (s) of named host spans."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name].append(time.perf_counter() - t0)


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def reduce_events(events) -> dict:
    """The traced window's numbers from profiler events (each with
    ``name``, ``device_type`` and ``time_range`` in µs): device activity
    (kernels, copies, fills) and the host's CUDA runtime calls."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        (device if e.device_type == cuda else host).append((e.name, *r))
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    lo = min(a for _, a, _ in device + host)
    hi = max(b for _, _, b in device + host)
    busy = _union([(a, b) for _, a, b in device])
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    # each gap is labelled by the runtime call the host was in at its
    # middle: the last call starting at or before it, if it still runs
    host.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][0] if i >= 0 and host[i][2] >= mid else "host"
        idle[label] += (b - a) / 1e6
    by_op, kernels = defaultdict(float), defaultdict(list)
    for name, a, b in device:
        by_op[name] += (b - a) / 1e6
        kernels[name].append((b - a) / 1e6)
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": sorted(([n[:120], s] for n, s in by_op.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda x: -x[1])[:TOP],
            "kernels": dict(kernels)}


def profiled(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under the profiler (CUDA activity), the device
    synchronised inside, and reduce its timeline (:func:`reduce_events`).
    A first session around one small operation takes the profiler's own
    start-up out of the window (a decode step under a process's first
    session read 54 ms on an H100, 36 ms under a later one)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return reduce_events(prof.events())
