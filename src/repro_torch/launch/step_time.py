"""Milliseconds a decode step of ``LMServer`` at full width, on one card.

    python src/repro_torch/launch/step_time.py [--label change] \
        [--src OTHER_CHECKOUT/src] [--calls 2]

Run it as a file: ``--src`` names the source directory whose
``repro_torch`` is timed (by default the one this file is in), so this
script times two checkouts of the port on the same card, in turns (A, B,
B, A), and a difference between them is the code's, not the host's.  The
step is host-bound (every step ends in the argmax's copy to the host), so
host speed moves it from one machine to the next: compare two trees only
within one call.  Products run under torch's default matmul settings
(``chip_smoke.py`` turns bfloat16 reduced-precision reduction off, so its
serving phases' steps take another time).

For each model of ``MODELS`` (the ``lm_serve`` and ``moe_serve`` phases of
``chip_smoke.py``: Qwen2.5-14B, 48 layers; Qwen2-MoE-A2.7B, 24 layers;
Qwen3-MoE-235B-A22B, 8 of its 94 layers), at full width in bfloat16 with
random weights from ``--seed``: ``LMServer(max_slots=8, max_len=1024)``,
8 prompts of ``--lens`` tokens drawn from the seed, ``max_new`` new tokens;
one call to warm up, then ``--calls`` timed calls.  Prints one JSON line
per model: ms a step of each call (seconds over steps), the steps, and
``gqa_decode``'s launches in the last call.

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

# (arch, layers or None for all, max_new)
MODELS = (("qwen2.5-14b", None, 32), ("qwen2-moe-a2.7b", None, 16),
          ("qwen3-moe-235b-a22b", 8, 16))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    ap.add_argument("--lens", default="16,64",
                    help="the shortest and longest prompt, in tokens")
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from repro_torch.configs.lm_family import get_config
    from repro_torch.kernels.gqa_decode import kernel as gk
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import LMServer

    if not torch.cuda.is_available():
        print("step_time.py: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lo, hi = (int(x) for x in args.lens.split(","))
    card = _card()
    for arch, layers, max_new in MODELS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        model = init_params(cfg, gen, dev)
        rng = np.random.default_rng(args.seed + 13)
        prompts = [rng.integers(0, cfg.vocab, size=int(m)).tolist()
                   for m in rng.integers(lo, hi + 1, size=8)]
        server = LMServer(model, max_slots=8, max_len=1024, device=dev)
        server.generate(prompts, max_new=max_new)
        ms = []
        for _ in range(args.calls):
            torch.cuda.synchronize()
            gk.launches = 0
            t0 = time.perf_counter()
            server.generate(prompts, max_new=max_new)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0)
                      / (max(map(len, prompts)) + max_new))
        print(json.dumps({
            "label": args.label, "src": args.src, "card": card,
            "arch": arch, "layers": cfg.n_layers,
            "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
            "steps": max(map(len, prompts)) + max_new,
            "ms_per_step": ms, "launches": gk.launches}), flush=True)
        del server, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
