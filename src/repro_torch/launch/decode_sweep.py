"""Sweep the two launch settings of the ``gqa_decode`` kernel on one card.

    python -m repro_torch.launch.decode_sweep [--reps 2]

The kernel (``csrc/gqa_decode.cu``) has two settings: U, the rows each row
group keeps in flight per step (the compile-time ``GQA_ROWS_IN_FLIGHT``),
and the blocks per SM that the wrapper's split count aims at
(``kernel.BLOCKS_PER_SM``).  This builds the kernel
once for each U in 1, 2, 4, 8 (one ``nvcc`` each, started together, into
``_build/``) and times every (U, blocks per SM) pair at the shapes that
``chip_smoke.py`` times: one Qwen2.5-14B layer at 4 × 32k, long_500k's
1 × 524,288 and the ``lm_serve`` cache of 8 × 1,024; bfloat16, G = 5,
D = 128, K and V drawn from a seed, every position valid.  A time is the
median of 30 launches by CUDA events, the L2 cache flushed before each.
The whole grid runs ``--reps`` times in the same order, so the spread
between passes shows.  Every setting's output is checked against the
plain version.  Prints one JSON line per setting and pass, then a summary
line with the default setting's times and the fastest per shape.

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref

ROWS_IN_FLIGHT = (1, 2, 4, 8)
BLOCKS_PER_SM = (2, 3, 4, 8, 16, 32)
SHAPES = ((4, 32_768), (1, 524_288), (8, 1_024))     # (B, S)
HKV, G, D = 8, 5, 128
DEFAULT = (int(re.search(r"#define GQA_ROWS_IN_FLIGHT (\d+)", (
    build.CSRC / "gqa_decode.cu").read_text()).group(1)),
    gqa_kernel.BLOCKS_PER_SM)
TIMED = 30


def build_variants(us=ROWS_IN_FLIGHT) -> dict:
    """{U: (library, ptxas line of the bfloat16 G = 5 partial kernel)}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for u in us:
        path = build.BUILD_DIR / f"libgqa_decode_u{u}.so"
        procs[u] = path, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-DGQA_ROWS_IN_FLIGHT={u}", "-o", str(path),
             str(build.CSRC / "gqa_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for u, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for U = {u}:\n{log}")
        out[u] = ctypes.CDLL(str(path)), ptxas_lines(
            log, "gqa_partial_kernelI13__nv_bfloat16Li5E")
    return out


def ptxas_lines(log: str, function: str) -> str:
    """The spill and register lines ``-Xptxas -v`` printed for the entry
    function whose mangled name holds ``function``."""
    found, lines = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = function in line
        elif found and ("spill stores" in line or "registers" in line):
            lines.append(line.split(" : ", 1)[-1].strip())
    return "; ".join(lines)


def time_ms(fn, flush) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def close(got, want) -> bool:
    """chip_smoke.py's deployment tolerance: |Δ| <= 1e-2·|want| +
    1e-3·rms(want)."""
    got, want = got.float(), want.float()
    rms = float(want.pow(2).mean().sqrt())
    return bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3 * rms).all())


def sweep(reps: int, seed: int = 0) -> list:
    dev = resolve_device(None)
    variants = build_variants()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    inputs = {}
    for b, s in SHAPES:
        q = torch.randn((b, HKV, G, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.empty((b, s, HKV, D), dtype=torch.bfloat16, device=dev
                            ).normal_(generator=gen) for _ in range(2))
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
        inputs[b, s] = (q, k, v, length), gqa_decode_ref(q, k, v, length)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    saved = gqa_kernel.BLOCKS_PER_SM, build._libs.get(gqa_kernel.NAME)
    try:
        for rep in range(reps):
            for (b, s), (args, want) in inputs.items():
                for u, (lib, regs) in variants.items():
                    build._libs[gqa_kernel.NAME] = lib
                    for bps in BLOCKS_PER_SM:
                        gqa_kernel.BLOCKS_PER_SM = bps
                        if not close(gqa_decode(*args), want):
                            raise AssertionError(
                                f"U = {u}, {bps} blocks an SM at {b} x {s}: "
                                "the kernel disagrees with its plain version")
                        row = dict(
                            shape=[b, s], u=u, blocks_per_sm=bps, rep=rep,
                            n_split=gqa_kernel.splits(b * HKV, s, sms)[0],
                            ms=time_ms(lambda: gqa_decode(*args), flush),
                            ptxas_g5=regs)
                        rows.append(row)
                        print(json.dumps(row), flush=True)
    finally:
        gqa_kernel.BLOCKS_PER_SM = saved[0]
        if saved[1] is None:
            build._libs.pop(gqa_kernel.NAME, None)
        else:
            build._libs[gqa_kernel.NAME] = saved[1]
    return rows


def summary(rows: list) -> dict:
    out = {}
    for b, s in SHAPES:
        mine = [r for r in rows if r["shape"] == [b, s]]
        best = min(mine, key=lambda r: r["ms"])
        out[f"{b}x{s}"] = dict(
            default_ms=[r["ms"] for r in mine
                        if (r["u"], r["blocks_per_sm"]) == DEFAULT],
            best={k: best[k] for k in ("u", "blocks_per_sm", "rep", "ms")},
            best_setting_ms=[r["ms"] for r in mine
                             if (r["u"], r["blocks_per_sm"])
                             == (best["u"], best["blocks_per_sm"])])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    rows = sweep(args.reps)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "default": {"u": DEFAULT[0],
                                  "blocks_per_sm": DEFAULT[1]},
                      "summary": summary(rows)}), flush=True)


if __name__ == "__main__":
    main()
