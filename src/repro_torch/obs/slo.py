"""Declared SLOs and multi-window burn-rate computation.

An :class:`SLO` declares what "good" means for one user-visible behavior;
the :class:`SLOMonitor` turns the cumulative metric families into
*windowed* bad-event fractions and reports them as **burn rates** — the
fraction of the error budget consumed per unit of budget, the signal a
production system pages on:

    burn = (bad events / total events in window) / (1 - objective)

``burn == 1`` means the window is eating budget exactly at the sustainable
rate; ``burn >> 1`` means the budget dies in hours.  Two windows guard
against both failure modes of single-window alerting: the *short* window
catches fast regressions quickly but flaps on blips, the *long* window is
stable but slow — requiring **both** to burn (``min`` across windows, the
Google SRE multi-window rule) fires fast on real sustained problems and
stays quiet on noise.  That min is what :class:`SLOSignalSource` feeds
the autopilot as ``GroupSignal.burn_rate``, so the hot-split policy can
trigger on sustained budget burn rather than one raw p95 spike.

Two SLO kinds:

* ``latency`` — over one histogram family (e.g.
  ``scatter_latency_ms{group}``): an observation is *bad* iff it exceeds
  ``threshold_ms`` (exact to bucket resolution, via
  ``Histogram.over_threshold_since`` — the same windowed-delta mechanism
  ``percentile_since`` uses).  Burn is computed per labeled series (so a
  ``group`` label yields per-group burns) and aggregated.
* ``ratio`` — over a good/bad counter pair (e.g. quorum commits vs
  quorum aborts): bad fraction = Δbad / (Δgood + Δbad).

Every computed burn is exported as the ``slo_burn_rate{slo,window}``
gauge family, so the admin server's ``/metrics`` and the BENCH trajectory
carry the same numbers the controller acts on.  Clock and windows are
injectable: the simulation harness runs the monitor on a ``SimClock``
with tick-denominated windows, deterministically.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .registry import MetricsRegistry, registry

# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

SeriesKey = Tuple[Tuple[str, str], ...]


@dataclass(frozen=True)
class SLO:
    """One declared objective.

    ``objective`` is the target good fraction (0.95 = "95 % of events
    good"); the error budget is ``1 - objective``.  ``latency`` SLOs name
    a histogram ``metric`` and a ``threshold_ms``; ``ratio`` SLOs name a
    ``good_metric``/``bad_metric`` counter pair.
    """

    name: str
    kind: str                     # "latency" | "ratio"
    objective: float
    metric: str = ""              # latency: histogram family
    threshold_ms: float = 0.0     # latency: good iff value <= threshold
    good_metric: str = ""         # ratio: success counter family
    bad_metric: str = ""          # ratio: failure counter family

    def __post_init__(self):
        if self.kind not in ("latency", "ratio"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind == "latency" and not self.metric:
            raise ValueError("latency SLO needs a metric family")
        if self.kind == "ratio" and not (self.good_metric and
                                         self.bad_metric):
            raise ValueError("ratio SLO needs good and bad counters")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


def default_slos(serving_threshold_ms: float = 50.0) -> Tuple[SLO, ...]:
    """The warren's production SLO set: serving p95, quorum-commit
    success, compaction pause."""
    return (
        SLO(name="serving_p95", kind="latency", objective=0.95,
            metric="scatter_latency_ms",
            threshold_ms=serving_threshold_ms),
        SLO(name="quorum_commit", kind="ratio", objective=0.999,
            good_metric="txn_quorum_commit_total",
            bad_metric="txn_quorum_abort_total"),
        SLO(name="compaction_pause", kind="latency", objective=0.99,
            metric="compaction_pause_ms", threshold_ms=50.0),
    )


class SLOMonitor:
    """Multi-window burn-rate computation over cumulative families.

    ``tick()`` snapshots every SLO's underlying series, computes each
    window's burn against the history, exports the
    ``slo_burn_rate{slo,window}`` gauges, and retains the snapshot.
    Windows are ``(name, seconds)`` pairs against the injected ``clock``
    — wall seconds in production, sim-ticks under a ``SimClock``.  An
    empty window (no events) burns 0: no traffic is not an outage.
    """

    def __init__(self, slos: Optional[Sequence[SLO]] = None,
                 windows: Sequence[Tuple[str, float]] = (("short", 60.0),
                                                        ("long", 600.0)),
                 reg: Optional[MetricsRegistry] = None,
                 clock=time.monotonic):
        if not windows:
            raise ValueError("need at least one window")
        self.slos = tuple(slos) if slos is not None else default_slos()
        self.windows = tuple((str(n), float(s)) for n, s in windows)
        self.reg = reg if reg is not None else registry()
        self.clock = clock
        horizon = max(s for _, s in self.windows)
        self._horizon = 2.0 * horizon
        # per slo: deque of (ts, {series_key: state}); state is a bucket
        # count list (latency) or a (good, bad) value pair (ratio)
        self._hist: Dict[str, deque] = {s.name: deque() for s in self.slos}
        self._last: Dict[str, Dict[str, float]] = {}
        self._last_groups: Dict[str, Dict[str, float]] = {}

    # -- capture ----------------------------------------------------------- #
    def _capture(self, slo: SLO) -> Dict[SeriesKey, object]:
        if slo.kind == "latency":
            return {tuple(sorted(labels.items())): h.bucket_counts()
                    for labels, h in self.reg.series(slo.metric)}
        good = {tuple(sorted(labels.items())): c.value
                for labels, c in self.reg.series(slo.good_metric)}
        bad = {tuple(sorted(labels.items())): c.value
               for labels, c in self.reg.series(slo.bad_metric)}
        return {key: (good.get(key, 0), bad.get(key, 0))
                for key in set(good) | set(bad)}

    @staticmethod
    def _base_state(hist: deque, now: float,
                    window_s: float) -> Optional[Dict]:
        """The newest snapshot at least ``window_s`` old (the window's
        start), falling back to the oldest retained one."""
        base = None
        for ts, state in hist:
            if ts <= now - window_s:
                base = state
            else:
                break
        if base is None and hist:
            base = hist[0][1]
        return base

    def _bad_total(self, slo: SLO, base: Optional[Dict],
                   cur: Dict) -> Tuple[Dict[SeriesKey, Tuple[int, int]],
                                       int, int]:
        """Per-series and aggregate (bad, total) event deltas."""
        per: Dict[SeriesKey, Tuple[int, int]] = {}
        agg_bad = agg_total = 0
        for key, state in cur.items():
            prev = base.get(key) if base else None
            if slo.kind == "latency":
                # map the key back to the live histogram for the delta
                h = self.reg.histogram(slo.metric, **dict(key))
                b, t = h.over_threshold_since(prev, slo.threshold_ms)
            else:
                g0, b0 = prev if prev is not None else (0, 0)
                g1, b1 = state
                b = max(b1 - b0, 0)
                t = max(g1 - g0, 0) + b
            per[key] = (b, t)
            agg_bad += b
            agg_total += t
        return per, agg_bad, agg_total

    # -- the control-rate read --------------------------------------------- #
    def tick(self) -> Dict[str, Dict[str, float]]:
        """Compute every SLO's per-window burn, export the gauges, retain
        the snapshot.  Returns ``{slo: {window: burn}}``."""
        now = self.clock()
        report: Dict[str, Dict[str, float]] = {}
        for slo in self.slos:
            cur = self._capture(slo)
            hist = self._hist[slo.name]
            burns: Dict[str, float] = {}
            group_burns: Dict[str, List[float]] = {}
            for wname, wsecs in self.windows:
                base = self._base_state(hist, now, wsecs)
                per, bad, total = self._bad_total(slo, base, cur)
                burn = ((bad / total) / slo.budget) if total > 0 else 0.0
                burns[wname] = burn
                if self.reg.enabled:
                    self.reg.gauge(
                        "slo_burn_rate",
                        "windowed error-budget burn rate (1.0 = budget "
                        "consumed exactly at the sustainable rate)",
                        slo=slo.name, window=wname).set(burn)
                for key, (b, t) in per.items():
                    g = dict(key).get("group")
                    if g is None or t <= 0:
                        continue
                    group_burns.setdefault(g, []).append(
                        (b / t) / slo.budget)
            report[slo.name] = burns
            # sustained per-group burn: min across windows, like the
            # aggregate — a group must burn in EVERY window to register
            self._last_groups[slo.name] = {
                g: min(v) for g, v in group_burns.items()
                if len(v) == len(self.windows)}
            hist.append((now, cur))
            while hist and hist[0][0] < now - self._horizon:
                hist.popleft()
        self._last = report
        return report

    # -- reads -------------------------------------------------------------- #
    def _burn_impl(self, slo_name: str,
                   window: Optional[str] = None) -> float:
        """Last computed burn for one SLO: a named window, or (default)
        the sustained burn — ``min`` across windows, the multi-window
        page rule.  NaN before the first ``tick``."""
        burns = self._last.get(slo_name)
        if not burns:
            return math.nan
        if window is not None:
            return burns.get(window, math.nan)
        return min(burns.values())
    burn = _burn_impl   # see the _impl note

    def _group_burns_impl(self, slo_name: str) -> Dict[str, float]:
        """Last computed sustained burn per ``group`` label value (empty
        for SLOs whose series carry no group label)."""
        return dict(self._last_groups.get(slo_name, {}))
    group_burns = _group_burns_impl   # see the _impl note

    def _report_impl(self) -> dict:
        """The full structure the admin server's ``/slo`` endpoint
        serves: declared objectives + last burns per window + per-group
        sustained burns."""
        out = []
        for slo in self.slos:
            out.append({
                "name": slo.name, "kind": slo.kind,
                "objective": slo.objective, "budget": slo.budget,
                "metric": slo.metric or None,
                "threshold_ms": (slo.threshold_ms
                                 if slo.kind == "latency" else None),
                "good_metric": slo.good_metric or None,
                "bad_metric": slo.bad_metric or None,
                "burn": self._last.get(slo.name, {}),
                "sustained_burn": self.burn(slo.name),
                "group_burns": self.group_burns(slo.name),
            })
        return {"windows": [{"name": n, "seconds": s}
                            for n, s in self.windows],
                "slos": out}
    report = _report_impl   # see the _impl note


class SLOSignalSource:
    """SignalSource decorator feeding sustained SLO burn to the autopilot.

    Wraps any ``collect() -> [GroupSignal]`` source: each collect first
    ticks the monitor, then stamps every signal's ``burn_rate`` with the
    group's sustained burn for ``slo_name`` (falling back to the
    aggregate when the group has no series of its own).  The controller's
    ``HotSplitPolicy.burn_hot`` threshold then triggers splits on
    *sustained budget burn* instead of a raw latency spike.
    """

    def __init__(self, inner, monitor: SLOMonitor,
                 slo_name: str = "serving_p95"):
        if not any(s.name == slo_name for s in monitor.slos):
            raise ValueError(f"monitor declares no SLO named {slo_name!r}")
        self.inner = inner
        self.monitor = monitor
        self.slo_name = slo_name

    def collect(self):
        sigs = self.inner.collect()
        self.monitor.tick()
        per_group = self.monitor.group_burns(self.slo_name)
        agg = self.monitor.burn(self.slo_name)
        for s in sigs:
            s.burn_rate = per_group.get(str(s.group), agg)
        return sigs
