"""Sweep the launch settings of the ``gqa_decode`` mma kernel on one card.

    python -m repro_torch.launch.decode_sweep [--reps 2]

The bfloat16 kernel for D ≤ 128 (``csrc/gqa_decode.cu``, the mma path) has
three settings: the positions per tile (``GQA_TILE``, 16 per warp), the
stages of its shared-memory ring (``GQA_STAGES``) and the blocks per SM
that the wrapper's split count aims at (``kernel.BLOCKS_PER_SM``).  This
builds the kernel once for each (tile, stages) in ``VARIANTS`` (one
``nvcc`` each, started together, into ``_build/``) and times every
variant at every blocks-per-SM setting at
the shapes that ``chip_smoke.py`` times: one Qwen2.5-14B layer at 4 × 32k,
long_500k's 1 × 524,288 and the ``lm_serve`` cache of 8 × 1,024; bfloat16,
G = 5, D = 128, K and V drawn from a seed, every position valid.  In the
same pass it times the yardsticks at each shape: the fma kernel (the
design before the mma path, at its own split rule) and
``F.scaled_dot_product_attention(enable_gqa=True)``.  A time is the median
of 30 launches by CUDA events, the L2 cache flushed before each.  The
whole grid runs ``--reps`` times in the same order, so the spread between
passes shows.  Every setting's output is checked against the plain
version.  Prints one JSON line per setting and pass, then a summary line
with the default setting's times, the yardsticks' and the fastest setting
per shape.

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

# (tile, stages)
VARIANTS = ((64, 2), (64, 3), (64, 4), (128, 2))
BLOCKS_PER_SM = (1, 2, 3, 4)
SHAPES = ((4, 32_768), (1, 524_288), (8, 1_024))     # (B, S)
HKV, G, D = 8, 5, 128
_SRC = (build.CSRC / "gqa_decode.cu").read_text()
DEFAULT = tuple(int(re.search(rf"#define {name} (\d+)", _SRC).group(1))
                for name in ("GQA_TILE", "GQA_STAGES")) \
    + (gqa_kernel.BLOCKS_PER_SM,)
TIMED = 30
SETTING = ("tile", "stages", "blocks_per_sm")


def build_variants(variants=VARIANTS) -> dict:
    """{(tile, stages): (library, ptxas line of the D = 128 mma
    kernel)}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tile, stages in variants:
        path = build.BUILD_DIR / f"libgqa_decode_t{tile}_s{stages}.so"
        procs[tile, stages] = path, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
             f"-DGQA_TILE={tile}", f"-DGQA_STAGES={stages}", "-o", str(path),
             str(build.CSRC / "gqa_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = ctypes.CDLL(str(path)), ptxas_lines(
            log, "gqa_mma_partial_kernelILi8E")
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


def yardsticks(args, flush) -> dict:
    """The fma kernel's and the library's ms at one shape."""
    import torch.nn.functional as F
    q, k, v, length = args
    b = q.shape[0]
    qs = q.reshape(b, HKV * G, 1, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    return dict(
        fma_ms=time_ms(lambda: gqa_kernel._launch(*args, gqa_kernel.FMA),
                       flush),
        sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, enable_gqa=True), flush))


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
    default_lib = build.load(gqa_kernel.NAME)
    saved_bps = gqa_kernel.BLOCKS_PER_SM
    try:
        for rep in range(reps):
            for (b, s), (args, want) in inputs.items():
                build._libs[gqa_kernel.NAME] = default_lib
                row = dict(shape=[b, s], rep=rep, **yardsticks(args, flush))
                rows.append(row)
                print(json.dumps(row), flush=True)
                for (tile, stages), (lib, regs) in variants.items():
                    build._libs[gqa_kernel.NAME] = lib
                    for bps in BLOCKS_PER_SM:
                        gqa_kernel.BLOCKS_PER_SM = bps
                        if not close(gqa_decode(*args), want):
                            raise AssertionError(
                                f"tile {tile}, {stages} stages, {bps} "
                                f"blocks an SM at {b} x {s}: the "
                                "kernel disagrees with its plain version")
                        row = dict(
                            shape=[b, s], tile=tile, stages=stages,
                            blocks_per_sm=bps, rep=rep,
                            n_split=gqa_kernel.splits(b * HKV, s, sms,
                                                      tile=tile)[0],
                            smem=gqa_kernel.mma_smem_bytes(D, tile, stages),
                            ms=time_ms(lambda: gqa_decode(*args), flush),
                            ptxas_d128=regs)
                        rows.append(row)
                        print(json.dumps(row), flush=True)
    finally:
        gqa_kernel.BLOCKS_PER_SM = saved_bps
        build._libs[gqa_kernel.NAME] = default_lib
    return rows


def summary(rows: list) -> dict:
    out = {}
    for b, s in SHAPES:
        here = [r for r in rows if r["shape"] == [b, s]]
        mine = [r for r in here if "ms" in r]
        best = min(mine, key=lambda r: r["ms"])
        setting = tuple(best[k] for k in SETTING)
        out[f"{b}x{s}"] = dict(
            default_ms=[r["ms"] for r in mine
                        if tuple(r[k] for k in SETTING) == DEFAULT],
            fma_ms=[r["fma_ms"] for r in here if "fma_ms" in r],
            sdpa_ms=[r["sdpa_ms"] for r in here if "sdpa_ms" in r],
            best={k: best[k] for k in (*SETTING, "rep", "ms")},
            best_setting_ms=[r["ms"] for r in mine
                             if tuple(r[k] for k in SETTING) == setting])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    rows = sweep(args.reps)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "default": dict(zip(SETTING, DEFAULT)),
                      "summary": summary(rows)}), flush=True)


if __name__ == "__main__":
    main()
