"""Deterministic day-in-the-life simulation harness for the autopilot.

Everything the :class:`~repro_torch.dist.autopilot.Controller` touches is
behind three injectable seams — SignalSource, Actuator, clock — and this
module provides the simulated side of each:

* :class:`SimClock` — a manually-advanced monotonic clock.  Nothing in
  the harness (or in the controller) reads the wall clock or sleeps, so
  a simulated "day" of drifting traffic runs in milliseconds and every
  run with the same seed produces byte-identical decision sequences.
* :class:`SimCluster` — a virtual sharded warren: groups own disjoint
  key ranges ``[lo, hi)`` of the unit interval, carry doc counts and
  per-replica seqnum high-water marks, and cost reads with a linear
  latency model (``p95 = base_ms + ms_per_doc * docs``) — the simplest
  model in which splitting a hot group visibly flattens its p95.  It is
  simultaneously the controller's SignalSource (``collect``) and its
  Actuator (``split``/``merge``/``demote``/``resync``), and it can
  inject :class:`~repro_torch.dist.rebalance.RebalanceAborted` on demand to
  exercise the backoff path without a real migration race.
* :class:`DriftingWorkload` — a seeded Zipf-over-topics query stream
  whose hot spot migrates at phase boundaries: topic ``i`` lives at a
  fixed key position, ranks are Zipf(s)-weighted, and every
  ``phase_ticks`` ticks the whole topic→key mapping rotates by an
  irrational stride, so yesterday's cold range becomes today's hot one.
  This is the "day in the life" the benchmark and the tier-1 tests both
  replay.

The harness lives under ``src/`` (not ``tests/``) deliberately:
``chip_smoke.py``'s phase ``autopilot`` (the day-in-the-life benchmark's
simulated day) and the tests import it through the package path.
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs
from repro_torch.dist.autopilot import GroupSignal
from repro_torch.dist.rebalance import RebalanceAborted


class SimClock:
    """Manually-advanced monotonic clock; pass the instance itself as the
    controller's ``clock`` (it is callable)."""

    def __init__(self, start: float = 0.0, step: float = 1.0):
        self._now = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: Optional[float] = None) -> float:
        self._now += self.step if dt is None else float(dt)
        return self._now


@dataclass
class SimGroup:
    """One virtual shard group: a key range, its committed docs, and a
    replica seqnum/health vector."""

    gid: int
    lo: float
    hi: float
    docs: int = 0
    demoted: bool = False
    retired: bool = False
    seqs: List[int] = field(default_factory=list)
    alive: List[bool] = field(default_factory=list)


class SimCluster:
    """A virtual warren that is both SignalSource and Actuator.

    Reads routed via :meth:`route` accrue per-group read counts for the
    next ``collect``; writes via :meth:`ingest` grow the owner's doc
    count and advance its live, non-diverged replica seqnums.  Latency is
    modeled, not measured: a group serving any reads reports
    ``p95 = base_ms + ms_per_doc * docs`` — linear in resident docs, so
    hot-spot growth raises p95 and a split halves it.

    ``actions`` records every applied actuator call as a tuple, the
    ground truth tests compare against the controller's Decision log.
    Failure injection: :meth:`kill` / :meth:`diverge` a replica,
    :meth:`inject_aborts` to make the next N calls of one action kind
    raise ``RebalanceAborted``.
    """

    def __init__(self, replicas: int = 2, docs: int = 0,
                 base_ms: float = 2.0, ms_per_doc: float = 0.05,
                 observe_latency: bool = False):
        self.replicas = replicas
        self.base_ms = base_ms
        self.ms_per_doc = ms_per_doc
        # observe_latency feeds each routed read's modeled latency into
        # the real scatter_latency_ms{group} histograms, so an
        # obs.SLOMonitor can compute burn rates over simulated traffic
        self.observe_latency = observe_latency
        self._lat_hists: Dict[int, obs.Histogram] = {}
        self.groups: List[SimGroup] = [SimGroup(
            gid=0, lo=0.0, hi=1.0, docs=docs,
            seqs=[0] * replicas, alive=[True] * replicas)]
        self.actions: List[Tuple] = []
        self._reads: Dict[int, int] = {}
        self._writes: Dict[int, int] = {}
        self._diverged: Set[Tuple[int, int]] = set()
        self._abort_next: Dict[str, int] = {}
        # non-adjacent merges park the absorbed key range here
        self._extra_ranges: Dict[int, List[Tuple[float, float]]] = {}

    # -- topology queries ------------------------------------------------ #
    def active(self) -> List[SimGroup]:
        return [g for g in self.groups if not g.retired]

    def owner(self, key: float) -> SimGroup:
        k = key % 1.0
        for g in self.active():
            if g.lo <= k < g.hi:
                return g
            for lo, hi in self._extra_ranges.get(g.gid, ()):
                if lo <= k < hi:
                    return g
        raise KeyError(f"no group owns key {k}")   # pragma: no cover

    def total_docs(self) -> int:
        return sum(g.docs for g in self.active())

    # -- traffic --------------------------------------------------------- #
    def route(self, keys: Sequence[float]) -> None:
        observe = self.observe_latency and obs.registry().enabled
        for k in keys:
            g = self.owner(k)
            self._reads[g.gid] = self._reads.get(g.gid, 0) + 1
            if observe:
                h = self._lat_hists.get(g.gid)
                if h is None:
                    h = obs.registry().histogram(
                        "scatter_latency_ms",
                        "per-group scatter fan-out latency",
                        group=g.gid)
                    self._lat_hists[g.gid] = h
                h.observe(self.base_ms + self.ms_per_doc * g.docs)

    def ingest(self, keys: Sequence[float]) -> None:
        for k in keys:
            g = self.owner(k)
            g.docs += 1
            self._writes[g.gid] = self._writes.get(g.gid, 0) + 1
            for r in range(len(g.seqs)):
                if g.alive[r] and (g.gid, r) not in self._diverged:
                    g.seqs[r] += 1

    # -- SignalSource ----------------------------------------------------- #
    def collect(self) -> List[GroupSignal]:
        out = []
        for g in self.groups:
            reads = self._reads.get(g.gid, 0)
            p95 = (self.base_ms + self.ms_per_doc * g.docs
                   if reads > 0 else math.nan)
            out.append(GroupSignal(
                group=g.gid, docs=0 if g.retired else g.docs, p95_ms=p95,
                reads=reads, writes=self._writes.get(g.gid, 0),
                demoted=g.demoted, retired=g.retired,
                replica_seqs=tuple(g.seqs), alive=tuple(g.alive)))
        self._reads.clear()
        self._writes.clear()
        return out

    # -- Actuator ---------------------------------------------------------- #
    def _maybe_abort(self, kind: str, group: int) -> None:
        n = self._abort_next.get(kind, 0)
        if n > 0:
            self._abort_next[kind] = n - 1
            raise RebalanceAborted(f"injected {kind} abort on group {group}")

    def split(self, group: int) -> int:
        self._maybe_abort("split", group)
        g = self.groups[group]
        if g.retired:
            raise ValueError(f"group {group} is retired")
        new_gid = len(self.groups)
        mid = (g.lo + g.hi) / 2.0
        moved = g.docs // 2
        ng = SimGroup(gid=new_gid, lo=mid, hi=g.hi, docs=moved,
                      demoted=False, retired=False,
                      seqs=list(g.seqs), alive=[True] * len(g.alive))
        g.hi, g.docs, g.demoted = mid, g.docs - moved, False
        self.groups.append(ng)
        self.actions.append(("split", group, new_gid))
        return new_gid

    def merge(self, dest: int, source: int) -> None:
        self._maybe_abort("merge", source)
        d, s = self.groups[dest], self.groups[source]
        if d.retired or s.retired:
            raise ValueError("merge with retired group")
        d.docs += s.docs
        # the dest takes over the source's key range (ranges need not be
        # adjacent in the sim; ownership is what matters)
        if s.hi == d.lo:
            d.lo = s.lo
        elif d.hi == s.lo:
            d.hi = s.hi
        else:
            self._extra_ranges.setdefault(dest, []).append((s.lo, s.hi))
        s.retired, s.docs = True, 0
        for rng in self._extra_ranges.pop(source, []):
            self._extra_ranges.setdefault(dest, []).append(rng)
        self.actions.append(("merge", dest, source))

    def demote(self, group: int) -> None:
        g = self.groups[group]
        if g.retired or g.demoted:
            raise ValueError(f"group {group} cannot demote")
        g.demoted = True
        self.actions.append(("demote", group))

    def resync(self, group: int, replica: int) -> None:
        self._maybe_abort("resync", group)
        g = self.groups[group]
        live = [q for q, a in zip(g.seqs, g.alive) if a]
        g.seqs[replica] = max(live, default=0)
        g.alive[replica] = True
        self._diverged.discard((group, replica))
        self.actions.append(("resync", group, replica))

    # -- failure injection -------------------------------------------------- #
    def kill(self, group: int, replica: int) -> None:
        self.groups[group].alive[replica] = False

    def diverge(self, group: int, replica: int, lag: int = 1) -> None:
        g = self.groups[group]
        g.seqs[replica] = max(0, g.seqs[replica] - lag)
        self._diverged.add((group, replica))

    def inject_aborts(self, kind: str, n: int) -> None:
        self._abort_next[kind] = self._abort_next.get(kind, 0) + n


class DriftingWorkload:
    """Seeded Zipf-over-topics query stream with hot-spot migration.

    ``topics`` fixed points on the unit interval receive Zipf(s)-ranked
    traffic; every ``phase_ticks`` ticks the rank→position mapping
    rotates by the golden-ratio stride, migrating the hot spot into what
    was a cold key range.  ``tick_keys()`` returns one tick's
    ``(read_keys, write_keys)`` and advances the phase — fully
    deterministic for a given seed.
    """

    STRIDE = 0.6180339887498949    # frac(golden ratio): maximally mixing

    def __init__(self, seed: int = 0, topics: int = 64,
                 reads_per_tick: int = 200, writes_per_tick: int = 0,
                 zipf_s: float = 1.2, phase_ticks: int = 40):
        self.rng = random.Random(seed)
        self.topics = topics
        self.reads_per_tick = reads_per_tick
        self.writes_per_tick = writes_per_tick
        self.phase_ticks = phase_ticks
        self.tick = 0
        w = [1.0 / (r ** zipf_s) for r in range(1, topics + 1)]
        total = sum(w)
        self._cum, acc = [], 0.0
        for x in w:
            acc += x / total
            self._cum.append(acc)

    @property
    def phase(self) -> int:
        return self.tick // self.phase_ticks if self.phase_ticks else 0

    def _topic_key(self, rank: int) -> float:
        # rank 0 is the hottest topic; its key position jumps each phase
        return ((rank / self.topics) + self.phase * self.STRIDE) % 1.0

    def _sample_rank(self) -> int:
        return bisect.bisect_left(self._cum, self.rng.random())

    def tick_keys(self) -> Tuple[List[float], List[float]]:
        reads = [self._topic_key(self._sample_rank())
                 for _ in range(self.reads_per_tick)]
        writes = [self._topic_key(self._sample_rank())
                  for _ in range(self.writes_per_tick)]
        self.tick += 1
        return reads, writes
