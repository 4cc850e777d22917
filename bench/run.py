"""Run one cell of the benchmark of ``repro_torch`` (``BENCHMARK.json``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch`` beside
``bench/``.  Prints the run's result as the last line of standard output
(one JSON object) and each number that decides ``correct`` beside its
limit as the last lines of standard error.  Exits non-zero, with no
result, where the machine lacks the cell's CUDA devices, where
``src/repro_torch`` is missing, or where a forbidden package (JAX or the
JAX package) was loaded.  Kernel and compiler caches live in
``.bench_cache/`` and ``src/repro_torch/_build/`` inside the checkout.
The process runs on the last ``HOST_CORES`` of the cores it may use, so
that the host work that paces a decode step runs on the same cores in
every run.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

HOST_CORES = 2
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def pin_host() -> None:
    """Bind this process, and the threads it starts later, to a fixed set
    of its allowed cores (before torch starts any)."""
    if hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cores[-HOST_CORES:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_host()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"{ROOT / 'src' / 'repro_torch'} is missing: the benchmark "
              f"runs the package beside bench/", file=sys.stderr)
        return 1
    from harness import core
    try:
        out = core.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except core.NoChip as e:
        print(f"no chip: {e}", file=sys.stderr)
        return 2
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    core.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
