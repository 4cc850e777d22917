"""One run of one cell: set-up, the measured window, an optional traced
sub-window, the check against the reference, the metrics, the result.

The window measures with the profiler off.  With ``trace`` a short
sub-window follows under ``torch.profiler`` (the mix's ``trace_steps`` or
``trace_calls``); per-layer metrics read the host spans of the measured
window and the device timeline of the traced one.  The check runs after
the device's memory peak has been read and the program's state freed.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

import torch

from . import check as C
from . import manifest
from .weights import model_shape

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class NoChip(RuntimeError):
    """The machine lacks the devices the cell asks for."""


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock, from
    ``/proc/self/stat`` (the module's import time where that is absent)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def chip(cell: dict) -> torch.device:
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < cell["chips"]:
        raise NoChip(f"{have} CUDA devices, the cell asks for "
                     f"{cell['chips']}")
    return torch.device("cuda", 0)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device=None, bench: Path = manifest.BENCH) -> dict:
    """The result line of one run (see the module's docstring); ``device``
    skips the look for a chip (the CPU tests)."""
    t_start = process_start()
    t_run = time.perf_counter()
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    dev = chip(cell) if device is None else torch.device(device)
    shape = model_shape(manifest.config(root, man, cell["config"]))
    mix = manifest.mix(cell["traffic"], bench)
    drv = manifest.driver(mix["kind"], bench)(shape, mix, seed, dev)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    # no collector pauses in the windows: set-up's objects are frozen
    # out of later collections, and collection waits until they close
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        win = drv.window(seconds)
        tr = drv.traced() if trace else None
    finally:
        gc.enable()
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    drv.release()
    got = drv.check()
    ok, checks = C.verdict(got["program"], manifest.limits(workload, bench))
    record = {"kind": mix["kind"], "shape": shape, "mix": mix,
              "setup_s": setup_s, "window": win, "trace": tr}
    wanted = (manifest.per_layer(man, workload) if trace
              else manifest.end_to_end(man, workload))
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], bench)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else
                  "cpu", "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": ok, "attempted": drv.tokens_attempted, "failed": 0,
           "metrics": metrics, "device": device_rec,
           # set-up's parts: the interpreter and the imports before the
           # run; the driver's CUDA start, weights, inputs and warm-up
           "setup_parts": {"before_run_s": t_run - t_start,
                           "driver_s": setup_s - (t_run - t_start)}}
    if tr is not None:
        device_rec.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["compared"] = {**got["compared"], **{
        k: v for k, v in got["program"].items() if k not in checks}}
    out["checks"] = checks
    del drv
    gc.collect()
    return out


def report(out: dict) -> None:
    """Each compared number beside its limit, last on standard error; the
    result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
