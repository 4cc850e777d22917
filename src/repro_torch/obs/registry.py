"""MetricsRegistry: labeled metric families + the two exporters.

One process-global registry (``repro_torch.obs.registry()``) collects every
metric family in the system.  A *family* is one metric name with one type
and N labeled children — ``scatter_latency_ms{group=3}`` and
``scatter_latency_ms{group=7}`` are two series of one family.  Accessors
are get-or-create and return the live metric object, so instrumentation
sites call ``registry().counter("x", group=g)`` freely; the same
(name, labels) pair always yields the same object.

Exporters:

* ``JsonlSink`` appends one ``{"ts": ..., "metrics": snapshot}`` line per
  ``write()`` — the persisted perf-trajectory form.
* ``to_prometheus()`` renders the text exposition format 0.0.4
  (histograms as cumulative ``_bucket{le=...}`` series plus
  ``_sum``/``_count``), for scraping or eyeballing.

``enabled`` gates every child metric's mutators (see
:mod:`repro_torch.obs.metrics`): disabling the registry turns the whole
instrumentation sweep into ~100 ns no-ops without unhooking anything.

A source that keeps its counts elsewhere (the MoE counters sum on the
device, ``models.transformer.MOE_COUNTS``) registers a collector with
:meth:`MetricsRegistry.add_collector`: both exporters call it first, so
it adds its counts to its counters only when the registry is read.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram

# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


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
        self._collectors: List[Callable[[], object]] = []

    # -- lifecycle -------------------------------------------------------- #
    def _enable_impl(self) -> None:
        self.enabled = True
    enable = _enable_impl   # see the _impl note

    def _disable_impl(self) -> None:
        self.enabled = False
    disable = _disable_impl   # see the _impl note

    def reset(self) -> None:
        """Zero every series (families and label sets survive)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for m in list(fam.children.values()):
                m.reset()

    # -- get-or-create accessors ------------------------------------------ #
    def _metric(self, cls, name: str, help: str, labels: dict, **kw):
        key = _label_key(labels)
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
            if help and not fam.help:
                fam.help = help
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

    # -- export ------------------------------------------------------------ #
    def add_collector(self, fn: Callable[[], object]) -> None:
        """Call ``fn()`` (once, however often it is added) before every
        :meth:`snapshot` and :meth:`to_prometheus`, outside the registry's
        lock, so that it can bring its counters up to date."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            fns = list(self._collectors)
        for fn in fns:
            fn()

    def snapshot(self) -> dict:
        """Plain-dict view of every family: name → {type, help, series}."""
        self._collect()
        with self._lock:
            fams = list(self._families.items())
        out = {}
        for name, fam in sorted(fams):
            series = []
            for key, m in sorted(fam.children.items()):
                series.append({"labels": dict(key), **m.snapshot()})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "series": series}
        return out

    def _series_impl(self, name: str) -> List[Tuple[Dict[str, str], object]]:
        """Live ``(labels, metric)`` pairs of one family (empty when the
        family does not exist) — the read surface for consumers that need
        the metric *objects* (windowed reads, SLO burn computation), not
        a frozen snapshot."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return []
            return [(dict(k), m) for k, m in sorted(fam.children.items())]
    series = _series_impl   # see the _impl note

    def _to_prometheus_impl(self) -> str:
        """Prometheus text exposition (format 0.0.4).  Counters and gauges
        render verbatim; histograms follow the histogram type rules:
        cumulative ``_bucket{le="..."}`` series in ascending bound order
        with a terminal ``le="+Inf"`` equal to ``_count``, plus ``_sum``
        and ``_count``.  Label values are escaped per the spec."""
        def esc(v: str) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
            items = dict(labels)
            if extra:
                items.update(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{esc(v)}"'
                            for k, v in sorted(items.items()))
            return "{" + body + "}"

        def num(v) -> str:
            if isinstance(v, float) and math.isnan(v):
                return "NaN"
            return repr(float(v)) if isinstance(v, float) else str(v)

        self._collect()
        with self._lock:
            fams = [(name, fam.kind, fam.help, sorted(fam.children.items()))
                    for name, fam in sorted(self._families.items())]
        lines = []
        for name, kind, help, children in fams:
            if help:
                lines.append(f"# HELP {name} {esc(help)}")
            lines.append(f"# TYPE {name} {kind}")
            for key, m in children:
                labels = dict(key)
                if kind == "histogram":
                    for le, cum in m.cumulative_buckets():
                        lines.append(
                            f"{name}_bucket{fmt_labels(labels, {'le': le})} "
                            f"{cum}")
                    lines.append(f"{name}_sum{fmt_labels(labels)} "
                                 f"{num(m.sum)}")
                    lines.append(f"{name}_count{fmt_labels(labels)} "
                                 f"{m.count}")
                else:
                    lines.append(f"{name}{fmt_labels(labels)} "
                                 f"{num(m.value)}")
        return "\n".join(lines) + "\n"
    to_prometheus = _to_prometheus_impl   # see the _impl note


class JsonlSink:
    """Appends registry snapshots to a JSONL file, one line per write."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def write(self, registry: MetricsRegistry,
              extra: Optional[dict] = None) -> dict:
        rec = {"ts": time.time(), "metrics": registry.snapshot()}
        if extra:
            rec.update(extra)
        rec = sanitize(rec)
        line = json.dumps(rec, sort_keys=True, allow_nan=False)
        with self._lock, open(self.path, "a") as fh:
            fh.write(line + "\n")
        return rec


def _sanitize_impl(obj):
    """NaN/inf → None, recursively — keeps every export strictly valid
    JSON (json.dumps would otherwise emit bare ``NaN`` tokens)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj
sanitize = _sanitize_impl   # see the _impl note


# -- process-global registry ------------------------------------------------ #
_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem reports into."""
    return _GLOBAL
