"""Schema-versioned benchmark emission — the persisted perf trajectory.

``emit()`` freezes the current registry snapshot into a ``BENCH_*.json``
file stamped with ``schema = "repro.bench/v1"`` and a *kind* (serving /
build / kernels / autopilot).  Committing those files turns git history into the
repo's performance trajectory: any PR that moves p95 scatter latency or
kernel roofline fraction shows up as a diff on a tracked file rather
than a silent regression.

``validate()`` checks a file against the schema — kind-specific required
metrics included — and returns a list of problems (empty = valid).  The
CLI form (``python -m repro_torch.obs.bench validate PATH``) is what the CI
``obs-smoke`` job gates on.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry, registry, sanitize

# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

SCHEMA = "repro.bench/v1"
KINDS = ("serving", "build", "kernels", "autopilot")

# Per-kind required metric families; histograms must carry percentiles.
REQUIRED: Dict[str, Tuple[str, ...]] = {
    "serving": ("serve_scatter_latency_ms", "serve_score_latency_ms",
                "serve_merge_latency_ms"),
    "build": ("build_docs_per_s",),
    "kernels": ("kernel_achieved_gflops", "kernel_phase_ms"),
    "autopilot": ("autopilot_actions_total", "autopilot_tick_ms",
                  "slo_burn_rate"),
}
_HIST_KEYS = ("count", "p50", "p95", "p99")


def _emit_impl(path: str, kind: str, extra: Optional[dict] = None,
               reg: Optional[MetricsRegistry] = None) -> dict:
    """Write a schema-versioned bench file from a registry snapshot."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    reg = reg if reg is not None else registry()
    doc = {"schema": SCHEMA, "kind": kind, "created": time.time(),
           "metrics": reg.snapshot()}
    if extra:
        doc.update(extra)
    doc = sanitize(doc)
    problems = validate_doc(doc)
    if problems:
        raise ValueError("refusing to emit invalid bench file: "
                         + "; ".join(problems))
    with open(path, "w") as fh:
        json.dump(doc, fh, sort_keys=True, indent=2, allow_nan=False)
        fh.write("\n")
    return doc
emit = _emit_impl   # see the _impl note


def validate_doc(doc: object) -> List[str]:
    """Schema problems in an in-memory bench document (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["top level is not a JSON object"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, want {SCHEMA!r}")
    kind = doc.get("kind")
    if kind not in KINDS:
        problems.append(f"kind is {kind!r}, want one of {KINDS}")
    if not isinstance(doc.get("created"), (int, float)):
        problems.append("created timestamp missing or non-numeric")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        problems.append("metrics missing or not an object")
        return problems
    for name in REQUIRED.get(kind, ()):
        fam = metrics.get(name)
        if not isinstance(fam, dict) or not fam.get("series"):
            problems.append(f"required metric {name!r} missing or empty")
            continue
        if fam.get("type") == "histogram":
            for s in fam["series"]:
                for key in _HIST_KEYS:
                    if key not in s:
                        problems.append(
                            f"{name} series {s.get('labels')} lacks {key!r}")
                if s.get("count", 0) <= 0:
                    problems.append(
                        f"{name} series {s.get('labels')} has no samples")
    return problems


def validate(path: str) -> List[str]:
    """Schema problems in a bench file on disk (empty = valid)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"unreadable: {e}"]
    return validate_doc(doc)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2 or argv[0] != "validate":
        print("usage: python -m repro_torch.obs.bench validate PATH",
              file=sys.stderr)
        return 2
    problems = validate(argv[1])
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"{argv[1]}: valid {SCHEMA}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
