"""Readings from which a cell's limits of ``correct`` are set.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control 1]

For each seed, in one process: the cell's set-up, a measured window of
``--seconds`` at the cell's own load, and the check, as ``run.py`` makes
them; with ``--control 1`` also the control, the reference computed in
float8 in the program's place, read against the float32 reference on the
same inputs.  One JSON line a seed on standard output.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from harness import core, manifest
    from harness.weights import model_shape
    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    dev = core.chip(cell)
    shape = model_shape(manifest.config(ROOT, man, cell["config"]))
    mix = manifest.mix(cell["traffic"])
    driver = manifest.driver(mix["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = driver(shape, mix, seed, dev)
        drv.setup()
        win = drv.window(args.seconds)
        torch.cuda.reset_peak_memory_stats(dev)
        drv.release()
        t1 = time.perf_counter()
        got = drv.check(bool(args.control))
        rec = {"workload": args.workload, "seed": seed,
               "work": win.get("steps", win.get("calls")),
               "window_s": win["seconds"], "check_s":
               time.perf_counter() - t1, "run_s": t1 - t0,
               "check_peak_bytes": torch.cuda.max_memory_allocated(dev),
               **got}
        print(json.dumps(rec), flush=True)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
