"""Autopilot: the closed-loop control plane over the rebalancing mechanism.

Every *mechanism* for reshaping a running
:class:`~repro_torch.dist.shard_router.ShardedWarren` already exists — live
split/merge (``repro_torch.dist.rebalance``), cold demotion/promotion
(``repro_torch.tiered``), fail-stop ``mark_failed``/
``resurrect`` — and the telemetry plane (``repro_torch.obs``) exposes the
signals.  This module is the part that *decides*: a :class:`Controller`
that watches per-group signals and autonomously keeps the warren balanced
under drifting, skewed traffic.

Architecture — three narrow interfaces, so the same controller runs
against a live warren in production and against a deterministic
simulation in tier-1:

* **SignalSource** — ``collect() -> [GroupSignal]``.  One
  :class:`GroupSignal` per shard group: committed doc count, windowed p95
  scatter latency, reads/writes in the window, per-replica seqnum
  high-water marks, demoted/retired flags.  :class:`WarrenSignals` reads
  a live warren (doc counts from the groups, windowed p95 via
  ``Histogram.percentile_since`` over the cumulative
  ``scatter_latency_ms{group}`` family); the simulation harness
  (``repro_torch.dist.simharness``) synthesizes streams from a seeded workload.
* **Actuator** — ``split``/``merge``/``demote``/``resync``.
  :class:`WarrenActuator` drives the real ``Rebalancer`` and warren;
  the simulator applies actions to its virtual cluster.  Failures
  surface as :class:`~repro_torch.dist.rebalance.RebalanceAborted`, which the
  controller absorbs with capped exponential backoff — it never wedges,
  and never holds any lock itself (locking is the mechanism layer's job).
* **Clock** — every timestamp comes from an injectable ``clock()``
  callable (default ``time.monotonic``).  The controller itself never
  sleeps; pacing belongs to the caller (``spawn`` for production, plain
  ``tick()`` loops in tests and benchmarks).  Tier-1 therefore runs the
  full control loop with a fake clock and asserts *exact* decision
  sequences.

Policies are frozen dataclasses (:class:`HotSplitPolicy`,
:class:`ColdPolicy`, :class:`AntiEntropyPolicy`) under a shared
:class:`Hysteresis` envelope.  Hysteresis is what makes the loop
trustworthy: a per-group **cooldown** after any action (so a split can
never be immediately reverted by a merge of the same group), a global
**min-dwell** after any action (the warren settles before the next
decision), and a **bounded action budget** per sliding window.  These are
mechanical properties of ``_plan`` — the property test in
``tests/test_autopilot.py`` checks them over arbitrary signal streams.

Every decision — applied, aborted, or failed — is recorded as a
structured :class:`Decision` (optionally appended to a JSONL decision
log) and counted in the ``autopilot_*`` metric families; each control
cycle runs under an ``autopilot.tick`` span.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.dist.rebalance import RebalanceAborted, Rebalancer

# --------------------------------------------------------------------- #
# signals
# --------------------------------------------------------------------- #


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

@dataclass
class GroupSignal:
    """One shard group's control inputs for one tick.

    ``p95_ms`` is the *windowed* p95 per-group scatter latency (NaN when
    the window holds no samples); ``reads``/``writes`` likewise count the
    window, not the lifetime.  ``replica_seqs`` are per-replica committed
    seqnum high-water marks and ``alive`` the fail-stop health vector —
    the anti-entropy inputs.
    """

    group: int
    docs: int = 0
    p95_ms: float = math.nan
    reads: int = 0
    writes: int = 0
    demoted: bool = False
    retired: bool = False
    replica_seqs: Tuple[int, ...] = ()
    alive: Tuple[bool, ...] = ()
    # sustained SLO burn rate (min across monitor windows), stamped by an
    # obs.SLOSignalSource wrapper; NaN when no SLO monitor is attached
    burn_rate: float = math.nan


class WarrenSignals:
    """SignalSource over a live ShardedWarren + the metrics registry.

    Doc counts and replica seqnums come straight from the groups;
    latency and read/write rates are *windowed* reads of the cumulative
    registry families (``scatter_latency_ms{group}``,
    ``shard_read_total{group}``, ``shard_write_total{group}``): each
    ``collect`` snapshots the histogram bucket counts and counter values
    and reports the delta since the previous ``collect``.  With the
    registry disabled the latency/rate fields degrade to NaN/0 and the
    controller still balances on doc-count skew.
    """

    def __init__(self, warren):
        self.warren = warren
        self._prev_buckets: Dict[int, List[int]] = {}
        self._prev_reads: Dict[int, int] = {}
        self._prev_writes: Dict[int, int] = {}

    def collect(self) -> List[GroupSignal]:
        reg = obs.registry()
        out: List[GroupSignal] = []
        for g, grp in enumerate(self.warren.groups):
            docs = grp.doc_count()
            seqs = tuple(grp.replica_seqnums())
            h = reg.histogram("scatter_latency_ms",
                              "per-group fan-out read time "
                              "(failover included)", group=g)
            p95 = h.percentile_since(self._prev_buckets.get(g), 0.95)
            self._prev_buckets[g] = h.bucket_counts()
            rc = reg.counter("shard_read_total", group=g).value
            wc = reg.counter("shard_write_total", group=g).value
            reads = rc - self._prev_reads.get(g, 0)
            writes = wc - self._prev_writes.get(g, 0)
            self._prev_reads[g], self._prev_writes[g] = rc, wc
            out.append(GroupSignal(
                group=g, docs=docs, p95_ms=p95, reads=reads, writes=writes,
                demoted=grp.demoted is not None, retired=grp.retired,
                replica_seqs=seqs, alive=tuple(grp.alive)))
        return out


class ScriptedSignals:
    """SignalSource replaying a canned per-tick schedule (tests and the
    benchmark's injected-stream scenarios).  Holds the last tick's
    signals once the script runs out."""

    def __init__(self, ticks: Sequence[Sequence[GroupSignal]]):
        if not ticks:
            raise ValueError("ScriptedSignals needs at least one tick")
        self._ticks = [list(t) for t in ticks]
        self._i = 0

    def collect(self) -> List[GroupSignal]:
        sigs = self._ticks[min(self._i, len(self._ticks) - 1)]
        self._i += 1
        return list(sigs)


# --------------------------------------------------------------------- #
# actuators
# --------------------------------------------------------------------- #
class WarrenActuator:
    """Actuator driving the real mechanisms on a live ShardedWarren."""

    def __init__(self, warren, rebalancer: Optional[Rebalancer] = None):
        self.warren = warren
        self.rebalancer = rebalancer if rebalancer is not None \
            else Rebalancer(warren)

    def split(self, group: int) -> int:
        return self.rebalancer.split_group(group)

    def merge(self, dest: int, source: int) -> None:
        self.rebalancer.merge_groups(dest, source)

    def demote(self, group: int) -> None:
        self.warren.demote_group(group)

    def resync(self, group: int, replica: int) -> None:
        """Anti-entropy re-sync: a replica that diverged while marked
        alive is outside the fail-stop model — fail it in place first,
        then stream it back from a healthy sibling.  A replica already
        marked dead resurrects directly."""
        grp = self.warren.groups[group]
        if grp.alive[replica]:
            grp.mark_failed(replica)
        self.warren.resurrect(group, replica)


# --------------------------------------------------------------------- #
# policies
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class HotSplitPolicy:
    """Split a group that is *sustainedly* hot: windowed p95 scatter
    latency at/above ``p95_hot_ms``, or doc count at/above ``skew_ratio``
    times the mean of the other active groups, or sustained SLO burn rate
    at/above ``burn_hot``, for ``sustain_ticks`` consecutive ticks.
    Groups below ``min_docs`` never split (nothing to partition) and the
    warren never grows past ``max_groups``.

    ``burn_hot`` defaults to +inf (disabled): burn only drives splits
    when an :class:`repro_torch.obs.SLOSignalSource` stamps
    ``GroupSignal.burn_rate`` and the operator opts in — burn 1.0 means
    the error budget is being consumed exactly at the sustainable rate,
    so thresholds slightly above 1 page on real sustained burn."""

    p95_hot_ms: float = 50.0
    skew_ratio: float = 3.0
    min_docs: int = 8
    sustain_ticks: int = 3
    max_groups: int = 16
    burn_hot: float = math.inf


@dataclass(frozen=True)
class ColdPolicy:
    """Demote, then merge away, groups that go idle (LRU-style).  A group
    with at most ``idle_reads`` reads per tick accrues idle ticks; at
    ``demote_after_ticks`` it is frozen to its static run set, at
    ``merge_after_ticks`` it is folded into the smallest other active
    group.  The warren never shrinks below ``min_groups`` active groups,
    and only groups at or below ``merge_max_docs`` are merge candidates
    (merging a huge group would re-create the hot spot)."""

    idle_reads: int = 0
    demote_after_ticks: int = 6
    merge_after_ticks: int = 10
    min_groups: int = 2
    merge_max_docs: int = 1 << 30


@dataclass(frozen=True)
class AntiEntropyPolicy:
    """Schedule a re-sync for a replica whose committed seqnum high-water
    mark trails its group's live maximum by more than ``max_seq_lag`` for
    ``sustain_ticks`` consecutive ticks — divergence the fail-stop model
    does not explain — and for dead replicas (plain resurrection)."""

    max_seq_lag: int = 0
    sustain_ticks: int = 2
    resync_dead: bool = True


@dataclass(frozen=True)
class Hysteresis:
    """The flap-guard envelope around every policy.

    * ``cooldown_ticks``: after an applied action touching a group, no
      further action may touch that group (or, for a split, the new
      group) for this many ticks — a split can provably not be reverted
      by a merge inside the window.
    * ``min_dwell_ticks``: after *any* attempted action, no action of any
      kind for this many ticks — the warren (and the windowed signals)
      settle before the next decision.
    * ``max_actions_per_window`` / ``window_ticks``: a hard budget on
      attempted actions inside any sliding window of ``window_ticks``
      ticks — total control activity is bounded no matter what the
      signals do.
    """

    cooldown_ticks: int = 5
    min_dwell_ticks: int = 2
    window_ticks: int = 20
    max_actions_per_window: int = 4


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff after an aborted/failed action on a
    group: attempt ``k`` blocks the group for
    ``min(cap_ticks, base_ticks * 2**(k-1))`` ticks."""

    base_ticks: int = 1
    cap_ticks: int = 8


@dataclass(frozen=True)
class PoolPolicy:
    """Keep the family's ScatterGather pool sized to the active group
    count (one worker per group leg, clamped) via ``resize``."""

    min_workers: int = 2
    max_workers: int = 16


@dataclass(frozen=True)
class AutopilotConfig:
    split: HotSplitPolicy = HotSplitPolicy()
    cold: ColdPolicy = ColdPolicy()
    anti_entropy: AntiEntropyPolicy = AntiEntropyPolicy()
    hysteresis: Hysteresis = Hysteresis()
    retry: RetryPolicy = RetryPolicy()
    pool: Optional[PoolPolicy] = PoolPolicy()
    max_actions_per_tick: int = 1


# --------------------------------------------------------------------- #
# decisions
# --------------------------------------------------------------------- #
@dataclass
class Decision:
    """One structured control decision — the replayable audit record.

    ``kind``     "split" | "merge" | "demote" | "resync"
    ``group``    the acted-on group (merge: the absorbed source)
    ``target``   split: the new gid (filled after the act); merge: the
                 surviving dest; resync: the replica; demote: None
    ``outcome``  "applied" | "aborted" (RebalanceAborted, table
                 unchanged) | "failed" (unexpected actuator error)
    """

    tick: int
    t: float
    kind: str
    group: int
    target: Optional[int] = None
    reason: str = ""
    outcome: str = "planned"
    detail: str = ""

    def to_record(self) -> dict:
        return {"tick": self.tick, "t": self.t, "kind": self.kind,
                "group": self.group, "target": self.target,
                "reason": self.reason, "outcome": self.outcome,
                "detail": self.detail}

    def summary(self) -> str:
        tgt = "" if self.target is None else f"->{self.target}"
        return (f"[tick {self.tick}] {self.kind} group {self.group}{tgt} "
                f"{self.outcome}: {self.reason}")


# --------------------------------------------------------------------- #
# the controller
# --------------------------------------------------------------------- #
class Controller:
    """The closed control loop: collect signals, plan under hysteresis,
    act, record.  One ``tick()`` is one full cycle; the controller holds
    no locks and never sleeps (see the module docstring)."""

    def __init__(self, signals, actuator,
                 config: Optional[AutopilotConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 pool=None, decision_log: Optional[str] = None):
        self.signals = signals
        self.actuator = actuator
        self.config = config if config is not None else AutopilotConfig()
        self.clock = clock
        self.pool = pool
        self.decision_log = decision_log
        self._log_sink: Optional[obs.RotatingJsonl] = None
        self.decisions: List[Decision] = []
        self._tick = 0
        self._hot: Dict[int, int] = {}           # group -> hot streak
        self._idle: Dict[int, int] = {}          # group -> idle streak
        self._lag: Dict[Tuple[int, int], int] = {}   # (group, replica)
        self._cooldown_until: Dict[int, int] = {}    # group -> last blocked tick
        self._backoff: Dict[int, Tuple[int, int]] = {}  # group -> (attempts, until)
        self._last_action_tick = -(1 << 30)
        self._action_ticks: deque = deque()      # attempted-action ticks

    @staticmethod
    def _for_warren_impl(warren, rebalancer: Optional[Rebalancer] = None,
                         config: Optional[AutopilotConfig] = None,
                         clock: Callable[[], float] = time.monotonic,
                         decision_log: Optional[str] = None,
                         slo_monitor=None) -> "Controller":
        """The production wiring: live signals + live actuator + the
        family's scatter pool (for PoolPolicy autoscaling).  Passing an
        ``obs.SLOMonitor`` wraps the signal source in an
        ``obs.SLOSignalSource`` so every GroupSignal carries its
        sustained serving-SLO burn rate (see HotSplitPolicy.burn_hot)."""
        signals = WarrenSignals(warren)
        if slo_monitor is not None:
            signals = obs.SLOSignalSource(signals, slo_monitor)
        return Controller(signals,
                          WarrenActuator(warren, rebalancer),
                          config=config, clock=clock,
                          pool=warren.scatter_pool,
                          decision_log=decision_log)
    for_warren = _for_warren_impl   # see the _impl note

    @property
    def tick_count(self) -> int:
        return self._tick

    # -- the control cycle --------------------------------------------- #
    def tick(self) -> List[Decision]:
        """One control cycle; returns the decisions attempted this tick
        (possibly empty).  Never raises on mechanism failures — aborts
        and errors become Decision outcomes with backoff."""
        t0 = self.clock()
        with obs.span("autopilot.tick", tick=self._tick):
            sigs = self.signals.collect()
            planned = self._plan(sigs)
            for d in planned:
                self._act(d)
                self.decisions.append(d)
                self._append_log(d)
            self._autoscale_pool(sigs)
        reg = obs.registry()
        if reg.enabled:
            reg.histogram("autopilot_tick_ms",
                          "control-cycle duration").observe(
                              1e3 * (self.clock() - t0))
            reg.gauge("autopilot_groups",
                      "active (non-retired) shard groups").set(
                          sum(1 for s in sigs if not s.retired))
            reg.counter("autopilot_ticks_total", "control cycles run").inc()
            for d in planned:
                reg.counter("autopilot_actions_total",
                            "control actions attempted",
                            kind=d.kind, outcome=d.outcome).inc()
        self._tick += 1
        return planned

    def _spawn_impl(self, interval_s: float) -> threading.Event:
        """Run ``tick`` on a daemon thread every ``interval_s`` seconds
        (wall clock); returns the stop event.  A tick that raises (a
        signal-source bug, not a mechanism failure — those become
        Decision outcomes) is counted and the loop keeps going."""
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    reg = obs.registry()
                    if reg.enabled:
                        reg.counter("autopilot_tick_errors_total",
                                    "ticks that raised").inc()

        threading.Thread(target=loop, daemon=True,
                         name="autopilot").start()
        return stop
    spawn = _spawn_impl   # see the _impl note

    # -- planning (pure: signals + controller state -> decisions) ------- #
    def _plan(self, sigs: List[GroupSignal]) -> List[Decision]:
        cfg = self.config
        hys = cfg.hysteresis
        tick = self._tick
        active = [s for s in sigs if not s.retired]
        self._update_streaks(sigs, active)

        # global dwell: the warren settles after ANY attempted action
        if tick <= self._last_action_tick + hys.min_dwell_ticks:
            return []
        planned: List[Decision] = []
        for cand in self._candidates(active):
            if len(planned) >= cfg.max_actions_per_tick:
                break
            if not self._window_budget_ok(tick, len(planned)):
                break
            touched = [cand.group] + (
                [cand.target] if cand.kind == "merge" else [])
            if any(self._blocked(g, tick) for g in touched):
                continue
            planned.append(cand)
        return planned

    def _update_streaks(self, sigs: List[GroupSignal],
                        active: List[GroupSignal]) -> None:
        split, cold, ae = (self.config.split, self.config.cold,
                           self.config.anti_entropy)
        live_gids = {s.group for s in active}
        for key in [g for g in self._hot if g not in live_gids]:
            self._hot.pop(key, None)
            self._idle.pop(key, None)
        for s in active:
            hot = False
            if s.docs >= split.min_docs:
                if s.p95_ms == s.p95_ms and s.p95_ms >= split.p95_hot_ms:
                    hot = True
                others = [o.docs for o in active if o.group != s.group]
                if others and s.docs >= split.skew_ratio * \
                        max(1.0, sum(others) / len(others)):
                    hot = True
                # sustained SLO budget burn (NaN-safe: NaN != NaN)
                if s.burn_rate == s.burn_rate and \
                        s.burn_rate >= split.burn_hot:
                    hot = True
            self._hot[s.group] = self._hot.get(s.group, 0) + 1 if hot else 0
            idle = s.reads <= cold.idle_reads
            self._idle[s.group] = (self._idle.get(s.group, 0) + 1
                                   if idle else 0)
            # anti-entropy: lag of each replica vs the live maximum
            live_seqs = [q for q, a in zip(s.replica_seqs, s.alive) if a]
            top = max(live_seqs, default=-1)
            for r, (seq, alive) in enumerate(zip(s.replica_seqs, s.alive)):
                diverged = (alive and seq < top - ae.max_seq_lag) or \
                    (not alive and ae.resync_dead)
                key = (s.group, r)
                self._lag[key] = self._lag.get(key, 0) + 1 if diverged else 0

    def _candidates(self, active: List[GroupSignal]) -> List[Decision]:
        """Every policy's eligible actions, in priority order: re-sync
        (repair before reshaping) > split (hot spots hurt now) > demote >
        merge.  Deterministic: ties break by group id."""
        cfg = self.config
        tick, now = self._tick, self.clock()
        by_gid = {s.group: s for s in active}
        out: List[Decision] = []

        ae = cfg.anti_entropy
        for (g, r), streak in sorted(self._lag.items()):
            if streak >= ae.sustain_ticks and g in by_gid \
                    and not by_gid[g].demoted:
                s = by_gid[g]
                dead = r < len(s.alive) and not s.alive[r]
                out.append(Decision(
                    tick=tick, t=now, kind="resync", group=g, target=r,
                    reason=("replica dead" if dead else
                            f"replica seq {s.replica_seqs[r]} trails live "
                            f"max {max(q for q, a in zip(s.replica_seqs, s.alive) if a)} "
                            f"beyond lag {ae.max_seq_lag}")
                    + f" for {streak} ticks"))

        sp = cfg.split
        if len(active) < sp.max_groups:
            hot = [s for s in active
                   if self._hot.get(s.group, 0) >= sp.sustain_ticks]
            for s in sorted(hot, key=lambda s: (-s.docs, s.group)):
                why = f"p95 {s.p95_ms:.1f} ms, {s.docs} docs"
                if s.burn_rate == s.burn_rate and \
                        s.burn_rate >= sp.burn_hot:
                    why += f", burn {s.burn_rate:.2f}"
                out.append(Decision(
                    tick=tick, t=now, kind="split", group=s.group,
                    reason=f"hot for {self._hot[s.group]} ticks ({why})"))

        cold = cfg.cold
        idle = sorted(((self._idle.get(s.group, 0), s) for s in active),
                      key=lambda t: (-t[0], t[1].group))
        for streak, s in idle:
            if streak >= cold.merge_after_ticks \
                    and len(active) > cold.min_groups \
                    and s.docs <= cold.merge_max_docs:
                dest = self._merge_dest(active, s.group)
                if dest is not None:
                    out.append(Decision(
                        tick=tick, t=now, kind="merge", group=s.group,
                        target=dest,
                        reason=f"idle for {streak} ticks "
                               f"({s.docs} docs) -> group {dest}"))
                    continue
            if streak >= cold.demote_after_ticks and not s.demoted \
                    and s.docs > 0:
                out.append(Decision(
                    tick=tick, t=now, kind="demote", group=s.group,
                    reason=f"idle for {streak} ticks ({s.docs} docs)"))
        return out

    def _merge_dest(self, active: List[GroupSignal],
                    source: int) -> Optional[int]:
        """Smallest other active group that is not itself blocked —
        folding cold data into the least-loaded survivor."""
        tick = self._tick
        best = None
        for s in sorted(active, key=lambda s: (s.docs, s.group)):
            if s.group == source or self._blocked(s.group, tick):
                continue
            best = s.group
            break
        return best

    def _blocked(self, group: int, tick: int) -> bool:
        if tick <= self._cooldown_until.get(group, -(1 << 30)):
            return True
        bo = self._backoff.get(group)
        return bo is not None and tick <= bo[1]

    def _window_budget_ok(self, tick: int, planned_now: int) -> bool:
        hys = self.config.hysteresis
        while self._action_ticks and \
                self._action_ticks[0] <= tick - hys.window_ticks:
            self._action_ticks.popleft()
        return (len(self._action_ticks) + planned_now
                < hys.max_actions_per_window)

    # -- acting ---------------------------------------------------------- #
    def _act(self, d: Decision) -> None:
        hys, retry = self.config.hysteresis, self.config.retry
        tick = self._tick
        self._action_ticks.append(tick)          # attempts consume budget
        self._last_action_tick = tick
        try:
            if d.kind == "split":
                d.target = self.actuator.split(d.group)
            elif d.kind == "merge":
                self.actuator.merge(d.target, d.group)
            elif d.kind == "demote":
                self.actuator.demote(d.group)
            elif d.kind == "resync":
                self.actuator.resync(d.group, d.target)
            else:                                # pragma: no cover
                raise ValueError(f"unknown decision kind {d.kind!r}")
        except RebalanceAborted as e:
            d.outcome, d.detail = "aborted", str(e)
            self._note_failure(d.group, tick, retry)
            return
        except Exception as e:
            d.outcome, d.detail = "failed", f"{type(e).__name__}: {e}"
            self._note_failure(d.group, tick, retry)
            return
        d.outcome = "applied"
        self._backoff.pop(d.group, None)
        touched = {d.group}
        if d.kind in ("split", "merge") and d.target is not None:
            touched.add(d.target)
        if d.kind == "resync":
            self._lag[(d.group, d.target)] = 0
        for g in touched:
            self._cooldown_until[g] = tick + hys.cooldown_ticks
            self._hot[g] = 0
            self._idle[g] = 0

    def _note_failure(self, group: int, tick: int,
                      retry: RetryPolicy) -> None:
        attempts = self._backoff.get(group, (0, 0))[0] + 1
        delay = min(retry.cap_ticks,
                    retry.base_ticks * (2 ** (attempts - 1)))
        self._backoff[group] = (attempts, tick + delay)

    def _autoscale_pool(self, sigs: List[GroupSignal]) -> None:
        pp = self.config.pool
        if pp is None or self.pool is None:
            return
        n_active = sum(1 for s in sigs if not s.retired)
        target = max(pp.min_workers, min(pp.max_workers, n_active))
        if target != self.pool.workers:
            self.pool.resize(target)

    # -- decision log ---------------------------------------------------- #
    def _append_log(self, d: Decision) -> None:
        if self.decision_log is None:
            return
        if self._log_sink is None or \
                self._log_sink.path != self.decision_log:
            self._log_sink = obs.RotatingJsonl(self.decision_log)
        self._log_sink.write(d.to_record())
