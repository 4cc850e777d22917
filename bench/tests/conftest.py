"""A tiny copy of the benchmark for the CPU tests.

``tiny_root`` is a directory holding ``BENCHMARK.json`` and ``bench/``
as the repository has them, plus three cells at a size the CPU runs in
seconds (a dense decode cell, a dense prefill cell whose attention runs
in blocks, an MoE prefill cell), each with limits of ``correct`` set
from the CPU's own readings.  The harness's code is the repository's
(``bench/`` on ``sys.path``); its data, drivers and readers are found
under the copy, as a run finds them.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=128,
                  vocab_size=512, max_position_embeddings=512)
# 4 layers of 16 experts, top 4: at 2 layers of 8, top 2, one routing
# flip by rounding moves a token's logits as far as float8 does
TINY_MOE = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=4, moe_intermediate_size=32,
                shared_expert_intermediate_size=64, num_experts=16,
                num_experts_per_tok=4, vocab_size=512,
                max_position_embeddings=512)
# each tiny cell compares the numbers its full-size cell compares; seeds
# 0-7 on the CPU: bfloat16 reads gap <= 0.045, gap_mean <= 0.0004 and
# logit_err <= 0.0092 (dense) or 0.019 (MoE); float8 reads gap >= 0.1,
# gap_mean >= 0.0032 (prefill) and logit_err >= 0.056 (decode)
TINY_LIMITS = {
    "tiny.decode": {"gap_mean": {"limit": 0.002},
                    "logit_err": {"limit": 0.04}},
    "tiny.prefill": {"gap": {"limit": 0.1}, "gap_mean": {"limit": 0.002},
                     "logit_err": {"limit": 0.04}},
    "tiny.moe": {"gap_mean": {"limit": 0.002}}}
CELLS = {"tiny.decode": ("tiny-dense", "tiny_decode"),
         "tiny.prefill": ("tiny-dense", "tiny_prefill"),
         "tiny.moe": ("tiny-moe", "tiny_prefill_x4")}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def make_tiny(root: Path) -> Path:
    (root / "bench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root)
    for sub in ("configs", "traffic", "metrics", "drivers", "limits"):
        shutil.copytree(BENCH / sub, root / "bench" / sub)
    b = root / "bench"
    dense = _json(b / "configs" / "internlm2-1.8b.json")
    dense.update(TINY_DENSE, name="tiny-dense")
    tiny = {"value": 16, "why": "tiny"}
    dense["assumed"] = dict(dense["assumed"], head_dim=tiny)
    moe = _json(b / "configs" / "qwen2-moe-a2.7b.json")
    moe.update(TINY_MOE, name="tiny-moe")
    # capacity for every assignment of 128 tokens' skewed routing
    moe["assumed"] = dict(moe["assumed"], head_dim=tiny, capacity_factor={
        "value": 4.0, "why": "tiny"})
    for c in (dense, moe):
        (b / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    dec = _json(b / "traffic" / "ruler_qa_32k_b20.json")
    dec.update(slots=4, cache_positions=256, context_tokens=[160, 192],
               answer_tokens=[8, 16], trace_steps=4)
    pre = _json(b / "traffic" / "ruler_qa_32k.json")
    pre.update(batch=1, prompt_tokens=128, attn_chunk=32,
               rows_checked=16)
    pre4 = dict(pre, batch=4, prompt_tokens=32, attn_chunk=64)
    for name, mix in (("tiny_decode", dec), ("tiny_prefill", pre),
                      ("tiny_prefill_x4", pre4)):
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    man = _json(root / "BENCHMARK.json")
    man["configs"] += [{"name": n, "source": "tiny", "why": "tiny",
                        "file": f"bench/configs/{n}.json", "reduced": []}
                       for n in ("tiny-dense", "tiny-moe")]
    for cell, (cfg, mix) in CELLS.items():
        man["workloads"].append({"name": cell, "config": cfg,
                                 "traffic": mix, "chips": 1, "why": "tiny"})
        (b / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS[cell]))
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            kind = "decode" if "decode" in m["name"] else "prefill"
            m["workloads"] += [c for c in CELLS if
                               (c == "tiny.decode") == (kind == "decode")]
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("bench_tiny"))


def tiny_run(root: Path, cell: str, seed: int = 7, seconds: float = 0.3):
    from harness import core
    return core.run(root, cell, seed, seconds, False, device="cpu",
                    bench=root / "bench")
