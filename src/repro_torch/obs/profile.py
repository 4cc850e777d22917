"""Continuous profiling: wall-clock sampling, lock contention, kernel phases.

Three instruments, all cheap enough to leave on in production:

* :class:`SamplingProfiler` — a ``sys._current_frames``-based wall-clock
  sampler.  A daemon thread wakes every ``interval_s``, snapshots every
  thread's Python stack, and aggregates them as collapsed stacks
  (``frame;frame;frame count`` lines, the flamegraph input format).
  Sampling is GIL-serialized and allocation-free per live frame walk, so
  at the default 10 ms interval the overhead on the concurrent serving
  smoke is under 5 % (measured in docs/architecture.md §6).  The admin
  server's ``/profile/cpu?seconds=N`` endpoint runs one on demand.
* :class:`ProfiledLock` — wraps a ``threading.Lock``/``RLock`` and times
  only *contended* acquires into the ``lock_wait_ms{lock}`` histogram
  family: the uncontended path is one extra non-blocking ``acquire``
  attempt, so wrapping a hot lock costs nanoseconds until it actually
  blocks.  Wired onto the shard-group write locks, the rebalance lock,
  the MicroBatcher close lock, the tiered maintenance lock, the WAL
  durability lock, and the checkpoint filesystem lock.  When a
  :class:`~repro_torch.obs.witness.LockWitness` is installed, every
  ProfiledLock acquire/release is also reported to it with the lock's
  profile name and optional ``order_key``, so the runtime lock-order
  checker sees exactly the locks the contention profiles see.
* :func:`phase_timer` — a context manager attributing device-kernel wall
  time to phases (host ``gather``/pack vs device ``compute``), feeding
  the ``kernel_phase_ms{kernel,phase}`` family that
  ``benchmarks/roofline.py --kernels`` reports and ``BENCH_kernels.json``
  persists — the DMA-vs-compute baseline the Pallas speed pass needs.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from .registry import registry
from . import witness as _witness


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

# --------------------------------------------------------------------- #
# wall-clock sampling profiler
# --------------------------------------------------------------------- #
class SamplingProfiler:
    """Collapsed-stack wall-clock sampler over ``sys._current_frames``.

    ``start()``/``stop()`` bracket a sampling window; ``collapsed()``
    returns the aggregate as flamegraph-compatible text (one
    ``name;name;name count`` line per distinct stack, root first).  The
    sampler thread skips itself and tags each stack with its thread name,
    so lock-wait parked threads, the MicroBatcher loop, and ScatterGather
    workers all show up as distinct towers.
    """

    def __init__(self, interval_s: float = 0.01, max_depth: int = 64):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.interval_s = interval_s
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._samples = 0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- sampling ---------------------------------------------------------- #
    def _walk(self, frame) -> str:
        parts = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            code = frame.f_code
            parts.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}"
                         f":{code.co_firstlineno})")
            frame = frame.f_back
            depth += 1
        parts.reverse()                     # root first, leaf last
        return ";".join(parts)

    def _sample_once(self, own_tid: int, names: Dict[int, str]) -> None:
        frames = sys._current_frames()
        stacks = []
        for tid, frame in frames.items():
            if tid == own_tid:
                continue
            name = names.get(tid, f"thread-{tid}")
            stacks.append(f"{name};{self._walk(frame)}")
        del frames                          # drop frame references promptly
        with self._lock:
            self._samples += 1
            for s in stacks:
                self._counts[s] = self._counts.get(s, 0) + 1

    def _run(self, stop: threading.Event) -> None:
        own_tid = threading.get_ident()
        while not stop.wait(self.interval_s):
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.ident is not None}
            self._sample_once(own_tid, names)

    # -- lifecycle --------------------------------------------------------- #
    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            raise RuntimeError("profiler already running")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,),
            daemon=True, name="obs-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._stop = None

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    # -- output ------------------------------------------------------------ #
    def collapsed(self) -> str:
        """Flamegraph-format collapsed stacks, hottest first."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{stack} {count}" for stack, count in items)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples = 0


def _profile_for_impl(seconds: float, interval_s: float = 0.01) -> str:
    """Sample every thread for ``seconds`` and return collapsed stacks —
    the one-shot form behind ``/profile/cpu?seconds=N``."""
    prof = SamplingProfiler(interval_s=interval_s)
    prof.start()
    try:
        time.sleep(max(seconds, interval_s))
    finally:
        prof.stop()
    return prof.collapsed()
profile_for = _profile_for_impl   # see the _impl note


# --------------------------------------------------------------------- #
# instrumented locks
# --------------------------------------------------------------------- #
class ProfiledLock:
    """A Lock/RLock wrapper that histograms *contended* wait time.

    The fast path tries a non-blocking acquire first: uncontended use
    costs one extra C-level call and never touches the metrics plane.
    Only when the lock is actually held elsewhere does the wrapper time
    the blocking acquire into ``lock_wait_ms{lock=<name>}`` and count it
    in ``lock_contended_total{lock=<name>}``.  Supports the full lock
    protocol (``with``, ``acquire(blocking, timeout)``, ``release``), and
    wrapping an ``RLock`` keeps reentrancy (the non-blocking attempt of
    an already-owned RLock succeeds).

    When a :class:`repro_torch.obs.witness.LockWitness` is installed, every
    acquire/release also reports to it with this lock's name and
    ``order_key`` (the ascending-order key for multi-instance lock
    classes, e.g. the shard group id for ``group_write``); with no
    witness installed the hook is one module-attribute load + ``is
    None`` test.
    """

    def __init__(self, name: str, lock=None, order_key: Optional[int] = None):
        self.name = name
        self.order_key = order_key
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
            w = _witness._active
            if w is not None:
                w.note_acquire(self.name, self.order_key, id(self._lock))
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        self._wait.observe(1e3 * (time.perf_counter() - t0))
        self._contended.inc()
        if ok:
            w = _witness._active
            if w is not None:
                w.note_acquire(self.name, self.order_key, id(self._lock))
        return ok

    def release(self) -> None:
        w = _witness._active
        if w is not None:
            w.note_release(self.name, id(self._lock))
        self._lock.release()

    def locked(self) -> bool:
        locked = getattr(self._lock, "locked", None)
        if locked is not None:
            return locked()
        # RLock has no locked(); probe without disturbing ownership
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __enter__(self) -> "ProfiledLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:                     # pragma: no cover
        return f"ProfiledLock({self.name!r}, {self._lock!r})"


# --------------------------------------------------------------------- #
# kernel phase attribution
# --------------------------------------------------------------------- #
@contextmanager
def phase_timer(kernel: str, phase: str):
    """Attribute a block's wall time to one kernel phase:
    ``kernel_phase_ms{kernel,phase}``.  Phases by convention: ``gather``
    (host-side packing / DMA staging) and ``compute`` (device dispatch +
    block-until-ready).  A disabled registry reduces this to two
    ``perf_counter`` calls."""
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
            "device-kernel wall time by phase (gather=host pack/DMA "
            "staging, compute=dispatch+ready)",
            kernel=kernel, phase=phase,
        ).observe(1e3 * (time.perf_counter() - t0))
