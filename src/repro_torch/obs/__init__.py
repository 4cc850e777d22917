"""repro_torch.obs — the unified telemetry plane, the JAX package's copied.

Stdlib-only (no jax/numpy), so every subsystem — core, dist, tiered,
train — can import it without cycles or optional-dependency gates.

Three layers:

* metrics: thread-safe Counter / Gauge / log-bucketed Histogram in a
  process-global :func:`registry` of labeled families, exported as a
  plain-dict snapshot, JSONL lines, or Prometheus text.
* tracing: contextvar-propagated :func:`span` trees with a ring buffer
  and slow-trace JSONL dump (see :mod:`repro_torch.obs.trace`).
* bench: schema-versioned ``BENCH_*.json`` emission + validation — the
  persisted perf trajectory (see :mod:`repro_torch.obs.bench`).

Plus the live introspection plane on top: continuous profiling and lock
contention (:mod:`repro_torch.obs.profile`), declared SLOs with multi-window
burn rates (:mod:`repro_torch.obs.slo`), size-capped JSONL rotation
(:mod:`repro_torch.obs.rotate`), and the HTTP admin server exposing all of it
(:mod:`repro_torch.obs.server`).

Disable everything (both planes drop to ~100 ns no-ops) with
:func:`disable`; re-enable with :func:`enable`.
"""

from .metrics import Counter, Gauge, Histogram
from .registry import JsonlSink, MetricsRegistry, registry, sanitize
from .trace import Span, Tracer, span, tracer
from .bench import SCHEMA as BENCH_SCHEMA
from .bench import emit as emit_bench
from .bench import validate as validate_bench
from .rotate import RotatingJsonl
from .profile import ProfiledLock, SamplingProfiler, phase_timer, profile_for
from .slo import SLO, SLOMonitor, SLOSignalSource, default_slos
from .server import AdminServer
from .witness import LockOrderViolation, LockWitness
from .witness import active as witness_active
from .witness import install as install_witness
from .witness import uninstall as uninstall_witness


def enable() -> None:
    """Turn on metrics and tracing process-wide."""
    registry().enable()
    tracer().enabled = True


def disable() -> None:
    """Turn off metrics and tracing process-wide (near-zero overhead)."""
    registry().disable()
    tracer().enabled = False


__all__ = [
    "Counter", "Gauge", "Histogram",
    "JsonlSink", "MetricsRegistry", "registry", "sanitize",
    "Span", "Tracer", "span", "tracer",
    "BENCH_SCHEMA", "emit_bench", "validate_bench",
    "RotatingJsonl",
    "ProfiledLock", "SamplingProfiler", "phase_timer", "profile_for",
    "SLO", "SLOMonitor", "SLOSignalSource", "default_slos",
    "AdminServer",
    "LockOrderViolation", "LockWitness",
    "install_witness", "uninstall_witness", "witness_active",
    "enable", "disable",
]
