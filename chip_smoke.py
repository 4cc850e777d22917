#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:

0. device: the card, its power limit, the matmul precision settings, and
   the five kernels' builds (set-up time; one nvcc for each source,
   started together) with their registers and spills (none may spill in
   gqa_decode, whose 34 instances include the mma kernel's 16-row ones,
   bm25_blockmax, embedding_bag or its backward);
1. the bm25_blockmax kernel against its plain version at the small shapes
   of the kernel tests (sweep, empty lists, one element, the θ tie
   boundary, BS off the warp width, k above the positive docs, T = 0) and
   at the kernel's edges (T = 17, BS = 132 and 96, NB off the block,
   impacts off 16 bytes);
2. ranked retrieval, the first slice's main path: index 12,000 seeded
   documents through the port's ``ingest_documents``, serve 512 queries
   from 8 client threads through ``RetrievalServer`` on the card, check
   them against the same server on the CPU (bit for bit) and against the
   float64 host oracle ``score_bm25``, and run ``bm25_blockmax_topk`` on
   the real index for 32 queries.  bm25_blockmax's launch count is zeroed
   just before and read just after;
3. deployment width: the block-max sweep over the doc space of MS MARCO
   v1 passage (8,841,823 docs, BS = 128, T = 8) with impacts made on the
   card from the seed, timed in turns (A B B A) with the one PyTorch call
   computing the unpruned sum, beside its device time, its plain version
   and the card's memory bound; and the dense ``bm25_topk`` at the 2^24
   accumulator;
4. join_small: the interval_join kernel against its plain version (on the
   card and on the host) and the dense all-pairs definition, both modes,
   at the kernel tests' shapes, empty lists, single elements, lengths off
   the tile, an A in no order, and cases that put a tile on each of the
   kernel's paths (a window one under, at and one over the budget, A in no
   order and sparse A over dense B, A with PAD gaps, an all-PAD A, A or B
   off 16 bytes) — exact, the kernel's tiles by path equal to
   ``tile_paths``'s;
5. structured, the second slice's main path: eight query-language queries
   that use every operator, on phase 2's warren, solved by the lazy host
   engine (``query.solve``) and by the vectorized operators composed by
   hand on the card; the solution lists must be equal.  interval_join's
   launch count is zeroed just before and read just after, and must equal
   the containment operators run;
6. json: the port's JSON store over ``json_collection(seed=0, scale=25)``
   with dates annotated post hoc, and the paper's nine Fig. 6 queries,
   lazy and on the card: equal counts and aggregates, query 1's values bit
   for bit;
7. deploy_join: interval_join at MS MARCO v1 passage's width, GC-lists
   made on the card from the seed — J1 ``word << [30 % of passages]``, J2
   ``[:] >> word``, and J1 with A in no order and A off 16 bytes — against
   its plain version and a numpy oracle; the kernel's tiles by path
   (sorted J1 and J2 must stage every valid tile); timed in turns with
   ``torch.searchsorted`` (the nearest single call), and against the
   plain version, the whole vectorized operator and the memory bound;
8. sharded: a ShardedWarren of 4 shard groups × 2 replicas (quorum
   commit, a WAL a replica written through ``core/packing.py``, async
   scatter) over the stream's first 3,000 documents (50,000 until the
   training slice, 10,000 until the dry run's, 5,000 until the mesh
   slice's), served natively by
   ``RetrievalServer`` on the card to phase 2's 512 queries from 8 client
   threads (p50, p95, queries/s, the scatter/score/merge breakdown and the
   idle share of 64 profiled queries); held against the same server on
   the host bit for bit and against a single index's rows over the same
   3,000 documents by
   (score, text), ties as sets (queries whose terms exceed the posting
   cap by a pair of uncapped servers: the cap's equal impacts keep
   address order, which differs by design); then 64 queries after each
   of a split of the largest group (`dist.elastic.split_shard_group`,
   the Rebalancer's swap stall, copy and catch-up), a merge of the two
   back (`merge_shard_groups`, the same stats), a
   demotion of another,
   failover of every replica 0 and their resurrection (group seqnums in
   lockstep), each time card against host and against the single index;
8a. autopilot, the control plane (slice 11): (a) the day-in-the-life
   benchmark's simulated day at its full sizes (seed 11, 400 ticks, a
   ``SimCluster`` of 1,200 documents under a ``DriftingWorkload`` of 48
   topics and 120 reads a tick), with the ``Controller`` and with no
   policy: the controller's worst-group p95 within 1.5 x its start, the
   no-policy day's peak above the controller's; then the burn-driven day
   (splits from ``HotSplitPolicy.burn_hot`` under an ``SLOMonitor`` on
   the sim clock), at least one split attributed to the burn; (b) a
   ``ShardedWarren`` of 2 groups × 2 replicas over the benchmark's 1,500
   documents, served by ``RetrievalServer`` on the card (the native
   sharded path) under ``Controller.for_warren`` on a ``SimClock``: hot
   traffic splits a group (capped at 3), ``mark_failed(0, 1)`` is
   resynced by anti-entropy, idle groups demote; after every applied
   decision and each stage the card's top-10 equals the host server's bit
   for bit and a single index's by (score, text); split, resync and
   demote must be applied and every replica live at the end; the
   ``LockWitness`` from ``analysis/lock_hierarchy.toml`` finds no
   violation, an ``AdminServer`` on 127.0.0.1 is scraped mid-split
   (``/metrics`` with ``scatter_latency_ms`` and ``autopilot_*``,
   ``/traces`` an ``autopilot.tick`` tree) and the decision log rotates
   through ``RotatingJsonl``;
9. tiered: a TieredStore over the stream's first 2,000 documents, frozen
   after each 400 but the last (4 runs and a hot memtable), 128
   queries on the card before and after one ``compact_runs``, the rows a
   Warren's of the same documents: same addresses, same score bits;
10. decode_small: the gqa_decode kernel against its plain version (on the
   card and on the host), float32 and bfloat16, at the reference kernel
   test's sweep, length 0, length = S, length > S, S off the tile, G = 5
   at D = 128, an odd D/8, and for the mma kernel lengths about its
   tile, a split ending inside a tile, S below the tile, one split at
   B·Hkv = 1024, D = 256 (the fma kernel in bfloat16), Hkv = 16 and 3,
   Qwen2-MoE-A2.7B's layer at phase 12b's cache (Hkv = 16, G = 1), and
   G = 9, 12 and 16 (the mma kernel's 16-row instance; the fma kernel in
   groups of 8 rows) at D = 64 and 128, lengths off the tile, length 0,
   length > S, several splits, and D = 256 at G = 16;
11. lm_serve, the third slice's main path: Qwen2.5-14B at full width in
   bfloat16 (48 layers, random weights from the seed on the card) behind
   ``LMServer(max_slots=8, max_len=1024)``, eight prompts of 16-64
   tokens, 32 new tokens each, twice (equal tokens).  gqa_decode's
   launch count is zeroed just before each call and read just after
   (48 × steps).  Every step's logits are held against the port's float32
   forward on the same tokens; the bfloat16 forward's distance from it
   sets the tolerance, and a decode with fp8-rounded weights must fail it.
   Then, at a well-conditioned init drawn only here (COND_RATIO), one
   layer at full width: the decode's logits against the same decode with
   the plain attention, within half the bf16 forward's distance from
   float32; the same decode with P rounded once to bfloat16 in P·V and
   an fp8-weight decode must fail that too;
12. decode_deploy: decode_step at 4 sequences of a 32k cache (lengths from
   the seed in 28,672-32,767, K and V from the seed) against the step's
   memory bound, one profiled window, and the kernel alone at one layer's
   [4, 32768, 8, 128] (K and V drawn anew from the seed; all S and the
   cache's lengths), at long_500k's [1, 524288, 8, 128], at
   Qwen2-MoE-A2.7B's [4, 32768, 16, 128] (G = 1) and at Qwen3-MoE-235B's
   [4, 32768, 4, 128] (G = 16), checked against its
   plain version with a tolerance scaled to the output and timed against
   it, the fma kernel (the design before the mma path),
   ``scaled_dot_product_attention`` and its bound;
12a. moe_small: ``moe_block`` and ``moe_dispatch`` on the card and on the
   host, float32 and bfloat16: no overflow, the three probes of the
   reference's scatter (fault (t): a dropped assignment overwrites a kept
   token's slot; the zeroed tokens zero on both), the decode's T = 8 at
   E = 60 (C = 1), an integer T·K/E·1.25, the shared expert and the
   renormalisation off, T = 4,096; the dispatch exact on both against
   ``dispatch_model`` (the reference's scatter in loops) given the same
   probabilities, two card calls the same bits, the output within
   RECSYS_RATIO × the host's distance from its float64 run;
12b. moe_serve, the MoE slice's main path: Qwen2-MoE-A2.7B at full width in
   bfloat16 (24 layers, 60 experts, top-4, a shared expert; random
   weights from the seed on the card, at phase 11's conditioned init: the
   logit check is blind at the reference's) behind
   ``LMServer(max_slots=8, max_len=1024)``, eight prompts of 8-32
   tokens (64-256 until phase 12c came, 32-128 until phase dist), 16 new
   tokens each, twice (equal
   tokens); gqa_decode's launch
   count zeroed just before each call and read just after (24 × steps).
   The logits are held against the same decode replayed in float32 with
   the plain attention and the decode's routing (T = 8 a step, so the
   same capacity, C = 1; an MoE forward over the same tokens has
   another); the bfloat16 replay's distance sets the tolerance, and an
   fp8-weight replay must fail it.  ms a step against two memory bounds:
   the gather formulation's (every expert's weights, since it computes
   all 60) and the function's (only the experts whose buffer holds a
   token), tokens/s, peak memory, and the shares of assignments dropped
   and of kept ones overwritten (fault (t)); then the conditioned check at
   one Qwen2-MoE layer (experts redrawn at N(0, 1/d_in) too);
12c. moe_serve_qwen3: the same phase for Qwen3-MoE-235B-A22B at full
   width in bfloat16 (d_model 4096, 64 query heads on 4 KV heads: G = 16,
   128 experts, top-8) with 8 of its 94 layers (the card's memory: 42.3
   GB), eight prompts of 64-256 tokens (the cache's data in two of
   gqa_decode's splits at the last steps, checked), 8 × steps gqa_decode
   launches through the mma kernel's 16-row instance, C = 1; its
   conditioned check
   at one Qwen3-MoE layer holds the G = 16 kernel against the plain
   attention, and the decode with P rounded once to bfloat16 must fail it;
13. bag_small: the embedding_bag kernel against its plain version (on the
   card and on the host) at the reference kernel test's sweep, D = 1, 10
   and 50, a bag of 33, B = 0, L = 0, all weights 0, ids in [-V, 0), ids
   out of range (NaN rows), rows wider than one pass, a table off 16
   bytes, bfloat16 tables, and the launch plan's shapes (bags of one at
   D = 64 and 16, L = 26, L = 8 at D = 256, 20 scalar elements) — bit for
   bit; bags of one against ``take``;
14. recsys_serve, the fourth slice's main path: DLRM-RM2, xDeepFM,
   two-tower and SASRec at their full configs (about 10 GB of tables,
   weights drawn on the card from the seed) served through
   ``recsys_family.serve`` at the serve_p99 batch (512, the synth batch at
   the seed), two-tower's and SASRec's retrieval_cand (1 × 1,000,000
   candidates), and SASRec's 512 scoring 64 shared candidates.
   embedding_bag's launch count is zeroed just before each call and read
   just after (1, 2, 2-3, 1-2 a call).  Each output is held against the
   same function on the CPU over only the rows its batch reads (4,096
   seeded candidates for retrieval_cand), within RECSYS_RATIO × the host's
   float32-vs-float64 distance; SASRec's all-zero score rows (fault (i))
   must be the host's.  ms per call, examples/s, peak memory, the idle
   share of a profiled window of 3 calls and the kernel's share of its
   device time;
15. bag_deploy: the kernel at serve_bulk's 262,144 — two-tower's history
   bag [262144, 8] over the 1 M × 256 item table (uniform and Zipf ids)
   and DLRM's field lookup (262,144 × 26 bags of one over [26 M, 64]) —
   bit for bit against its plain version, timed in turns (A B B A) with
   the one PyTorch call (``F.embedding_bag``, ``F.embedding``), beside its
   device time, its plain version, the bound over distinct rows and the
   bound over every reference (``bound_refs_ms``: the floor where the L2
   cannot hold the table);
16. bag_backward_small: the embedding_bag backward kernel bit for bit
   against the plain model of its order (``embedding_bag_backward_sorted_
   ref``, NaN masks equal), two calls the same bits, and against the
   item-order plain version (on the card and on the host) per element
   within n · 2^-23 · Σ|terms| (plus a bfloat16 ulp for bfloat16), the
   bound printed: ids named again within and across bags, wrapped and
   dropped ids, zero weights, float32 and bfloat16, D not a multiple of 4,
   B = 0, two vectors a lane, grad_out off 16 bytes, a table off 16 bytes
   through the autograd Function, inf and NaN in grad_out rows of bags
   with zero-weight items (fault (s): NaN where the reference has it), rows
   named far more than PIECE times, runs of exactly PIECE and PIECE + 1;
17. train_lm, the training slice's path A: the port's pipeline over 16
   seeded documents of about 8,192 words (ingest, ``dup:``, 4,096-token
   ``seg:`` windows), ``IndexedCorpusLoader``, then ``Trainer`` on
   InternLM2-1.8B at full width in bfloat16 (random weights from the
   seed, remat, attention chunks of 1,024) at train_4k's sequence, 4
   sequences a step (the global 256 cut to what one card holds), 3
   steps, no checkpoint (a train state is 23 GB); step ms, tokens/s, peak
   memory and the model FLOPs' share of the bf16 peak; the cursor
   advances by batch × steps, and two steps on one repeated batch lower
   its loss (the second profiled: idle share, device time by kernel);
18. train_small: the checkpoint path on the card at the smoke config,
   float32 with TF32 off: ``run_with_restarts`` with a crash injected at
   step 7 resumes from the newest published checkpoint (step 6's, or an
   earlier one where the asynchronous write is still in flight) and its
   cursor, reaches step 10, and agrees with an uninterrupted card run; 3
   card steps against 3 host steps (the host's float32-vs-float64 spread, or what an AdamW
   step can move a coordinate);
19. train_recsys, path B: DLRM-RM2 and two-tower (``loss_chunk`` 4,096)
   at full width and train_batch 65,536, 3 steps on one repeated batch
   through ``Trainer`` (the loss falls), embedding_bag's forward and
   backward launch counts zeroed just before and read just after (1 and
   3 a step each), step ms, examples/s, peak memory, one more step
   profiled; each lookup of one more step through both kernels, the
   backward bit for bit against its sorted model; then the four models at
   their smoke configs, 3 card steps against 3 host steps;
20. bag_backward_deploy: the backward kernel at DLRM's train shape
   (65,536 × 26 bags of one over [26 M, 64]) and two-tower's history
   bags ([65,536, 8] over [10^6, 256], Zipf and uniform ids), bit for bit
   against its sorted model and twice, within the bound of the item-order
   plain version, timed in turns with autograd's backward of
   ``F.embedding_bag``, beside its device time (every kernel of a call,
   and each part: keys, sort, reduction, combine), ``torch.sort(stable=
   True)`` of the same keys, the kept items, runs, long runs and pieces,
   its plain version and the bound over distinct rows (read and written
   once);
21. gnn_small: NequIP's smoke config, node classification on the smoke
   graph and energies and forces on the smoke molecules (a self loop
   among their edges), on the card against the same function on the host
   in float32 and float64 (RECSYS_RATIO × the host's distance + 1 ulp),
   each also on its input rotated: logits and energies unchanged and
   forces rotated, on the card, within the same rule on the host's
   distances at both inputs; ``loss_fn``'s value and gradients card
   against host;
22. gnn_serve: NequIP at its full config on two cells, the same checks:
   minibatch_lg (a 232,965-node parent graph at mean degree 25 from
   ``random_graph``, ``NeighborSampler`` of 1,024 seeds at fanout 15-10,
   ``classify`` with 602 features and 41 classes on the subgraph) and
   molecule (``molecule_batch`` of 128 molecules of 30 nodes and 64
   edges, ``energy_and_forces``); ms a call (host clock, synchronised),
   nodes/s, seeds/s, graphs/s, peak memory;
23. dryrun, the registry's one-card dry run: ``launch.dryrun.run_cell``
   on the card's fakes (no memory, no data; the kernels' fake
   implementations) for InternLM2-1.8B's long_500k (a 524,288-position KV
   cache), DLRM-RM2's serve_p99 and NequIP's molecule (a train step,
   forces included), then each step for real at full width (weights and
   inputs from the seed, the cache at length S − 1): the estimated peak
   within 5 % or 256 MiB of the allocator's, the FLOP counts equal, and
   for long_500k the estimate without the KV cache refused; gqa_decode's
   and embedding_bag's launch counts zeroed just before each real step
   and read just after (24 and 1);
24. dispatch: the host µs a call of gqa_decode and embedding_bag through
   their operators and through their eager bodies, in turns (op, body,
   body, op): what the dispatcher adds to a call;
25. dist, the meshes, sharding and compressed reduce (slice 10): (a)
   gqa_decode at G in {24, 40} and D in {36, 100, 320} (and 128 on the
   mma kernel's row tiles), float32 and bfloat16, against its plain
   version on the card and the host, each timed against it (fault (w));
   (b) one NCCL rank over a ``file://`` store and ``make_local_mesh()``
   over the card: InternLM2-1.8B at full width in bfloat16 from the seed
   decodes 4 sequences (128-token prompts, then 32 new tokens, greedy) on
   plain tensors, then again with its parameters ``reshard``-ed onto
   ``lm_param_sharding`` and its cache onto ``lm_cache_sharding`` (DTensors
   through the operators' sharding rules): the same tokens and every
   step's logits bit for bit, gqa_decode 24 launches a DTensor step; (c)
   ``cross_pod_reduce_compressed`` over a ``("pod",)`` mesh of that rank
   on real NCCL all-reduces of its int32 lanes, InternLM2-1.8B's layer-0
   gradient shapes from the seed: result and residual bit for bit with
   ``decompress(compress_with_feedback(...))``, then the group is
   destroyed; (d) the production dry run, in a subprocess started after
   the kernels' build, beside every phase (a fake group of 256 ranks
   cannot share a process with the NCCL one) at one cell a family on the card's fakes of the 16×16 mesh:
   InternLM2-1.8B train_4k,
   Qwen3-MoE decode_32k, DLRM-RM2 train_batch, NequIP minibatch_lg, and
   Qwen2-MoE-A2.7B train_4k (a cell of fault (x)) — each device's peak,
   fits, FLOPs and collectives;
26. the kernels line; the last line is ``{"ok": true, "device": ...}``.
    The ``done`` line holds every phase's seconds.

It needs a CUDA card and the repository's ``src/`` beside it, and exits
non-zero without a result otherwise.
"""

import atexit
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
N_DOCS = 12_000           # 50,000, then 40,000 until slices 7b-8, 30,000
                          # until the mesh slice's phase dist (run time)
N_QUERIES = 512
N_CLIENTS = 8
N_ORACLE = 32
MSMARCO_PASSAGES = 8_841_823
BS = 128
T_DEPLOY = 8
K1, B = 0.9, 0.4
TIMED_LAUNCHES = 30
TIE_RTOL = 1e-6
JSON_SCALE = 25.0         # 50 until the mesh slice's phase dist (run time)
N_SHARDS = 4
N_REPLICAS = 2
STEP_QUERIES = 64   # after each sharded step; 128 took the run past 600 s
SHARDED_DOCS = 3_000      # phase 8's corpus (50,000 until the training
                          # slice, 10,000 until the dry run's, 5,000 until
                          # the mesh slice's)
TIERED_QUERIES = 128
K_TIES = 64
MAX_TERMS = 8             # the server's default max_terms
UNCAPPED = 1 << 30        # max_postings that binds no list
TIERED_DOCS = 2_000       # 5,000 until the mesh slice's phase dist
FREEZE_EVERY = 400         # 1,000 at 5,000 documents


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sync(dev) -> None:
    """End a phase: wait for the card, so a fault shows where it
    happened (the phases also run on the CPU, from the tests)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# card facts
# --------------------------------------------------------------------- #
def card_peaks(name: str):
    """(memory bytes/s, float32 ops/s, label) from the published data
    sheets, by the name torch reports."""
    if "H200" in name:
        return 4.8e12, 67e12, "H200 SXM: 4.8 TB/s, 67 TFLOP/s fp32"
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe: 2.0 TB/s, 51 TFLOP/s fp32"
    if "H100" in name:
        return 3.35e12, 67e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32"
    raise RuntimeError(f"no published peaks on file for {name!r}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` output → {mangled function: its spill and register
    lines}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("spill stores" in line or "registers" in line):
            line = line.split(" : ", 1)[-1].strip()
            out[fn] = f"{out[fn]}; {line}" if fn in out else line
    return out


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #
SPIN_CYCLES = 400_000    # about 0.2 ms of the card's clock


def time_cuda(fn, n: int = TIMED_LAUNCHES, flush=None) -> float:
    """Median ms of ``fn()`` over ``n`` runs after 3 warm-ups, each run
    bracketed by its own CUDA events; ``flush()`` (outside the events)
    evicts the L2 cache before every run, and a spin of SPIN_CYCLES on
    the card after it keeps the card busy while the host records the
    start event and runs ``fn``'s Python, so a slow host's launch path
    does not show as time between the events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_in_turns(calls: dict, flush=None):
    """Each of ``calls`` (name → fn) timed by :func:`time_cuda` in turns,
    A B ... B A, ``TIMED_LAUNCHES // 2`` runs each time.  Returns ({name:
    the mean of its two medians}, {name: [the two medians]})."""
    turns = {key: [] for key in calls}
    for key in [*calls, *reversed(calls)]:
        turns[key].append(time_cuda(calls[key], n=TIMED_LAUNCHES // 2,
                                    flush=flush))
    return {key: float(np.mean(t)) for key, t in turns.items()}, turns


PROFILE_TRIES = 3


def device_events(fn):
    """Run ``fn`` under the profiler: ([(device activity, ms)], wall ms).
    A window now and then comes back with no device activity at all (seen
    in phase 2 on an H100), so such a window runs again, up to
    PROFILE_TRIES times, before the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events, wall_ms
        emit("profiler_empty_window", attempt=attempt + 1)
    raise AssertionError(f"the profiler saw no device activity in "
                         f"{PROFILE_TRIES} windows")


def device_busy(fn) -> dict:
    """Run ``fn`` under the profiler: wall time, summed device activity
    (kernels and copies) and the top device activities by time."""
    events, wall_ms = device_events(fn)
    by_name = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [[name[:60], ms] for name, ms in top]}


def kernel_device_ms(fn, kernel_name: str, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of the CUDA kernel ``kernel_name`` per call of
    ``fn`` over ``n`` calls, from the profiler's device events: the
    kernel's own time, without the host's launch path around it.  The
    profiler may drop events, so the mean is over the launches it kept (at
    least half; a window with fewer runs again, up to PROFILE_TRIES
    times)."""
    import torch
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        events, _ = device_events(lambda: [fn() for _ in range(n)])
        times = [ms for name, ms in events if kernel_name in name]
        if n // 2 <= len(times) <= n:
            return float(np.mean(times))
        emit("profiler_dropped", kernel=kernel_name, seen=len(times),
             launched=n, attempt=attempt + 1)
    raise AssertionError(f"profiler saw {len(times)} launches of "
                         f"{kernel_name}, expected {n}")


def kernels_device_ms(fn, prefix: str, per_call: dict,
                      n: int = TIMED_LAUNCHES) -> dict:
    """Mean device time per call of ``fn`` of each CUDA kernel named
    ``<prefix>_<name>`` (a call that launches several kernels), with
    ``per_call`` {name: its launches a call}: {name: ms a call, ...,
    "total": their sum}.  As in :func:`kernel_device_ms` the profiler may
    drop events, so each mean is over the launches it kept (at least
    half)."""
    import torch
    pat = re.compile(re.escape(prefix) + r"_([a-z_]+)")
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        events, _ = device_events(lambda: [fn() for _ in range(n)])
        seen = {}
        for name, ms in events:
            m = pat.search(name)
            if m:
                seen.setdefault(m.group(1), []).append(ms)
        if set(seen) == set(per_call) and all(
                n // 2 * k <= len(seen[key]) <= n * k
                for key, k in per_call.items()):
            split = {key: k * float(np.mean(seen[key]))
                     for key, k in per_call.items()}
            return {**split, "total": sum(split.values())}
        emit("profiler_dropped", kernel=prefix, launched=n,
             seen={key: len(t) for key, t in seen.items()},
             attempt=attempt + 1)
    counts = {key: len(t) for key, t in seen.items()}
    raise AssertionError(f"profiler saw {counts} launches of {prefix}_*, "
                         f"expected {per_call} × {n}")


def all_device_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time per call of ``fn``: every kernel and copy it
    launches, from the profiler (the events it kept, over ``n``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    events, _ = device_events(lambda: [fn() for _ in range(n)])
    return sum(ms for _, ms in events) / n


def sweep_bound(t: int, nb: int, bs: int, kept: int, bw: float,
                flops: float):
    """(bound_ms, bound_by, bytes) of the pruned sweep: the larger of the
    bytes it must move (block maxima, the kept blocks' impact tiles and the
    output, each once) over the memory rate, and its float32 adds over the
    card's float32 rate."""
    nbytes = 4 * (t * nb + t * bs * kept + nb * bs)
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * (t * nb + t * bs * kept) / flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def max_err(a, b) -> float:
    """max |a - b| over finite entries; raises if the -inf pattern
    differs."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), "kernel and plain version prune different "
                               "blocks")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa] - b[fb]).abs().max())


# --------------------------------------------------------------------- #
# phase 1: kernel vs plain at the kernel tests' shapes
# --------------------------------------------------------------------- #
def small_cases():
    """(name, impacts [T, NB, BS] f32, k), from fixed seeds."""
    cases = []
    for t, nb, bs, k in [(4, 8, 128, 10), (8, 32, 128, 25), (2, 4, 256, 5),
                         (16, 16, 128, 100)]:
        rng = np.random.default_rng(t * 100 + nb)
        imp = rng.random((t, nb, bs), dtype=np.float32)
        imp *= rng.random((t, nb, bs)) < 0.1
        cases.append((f"sweep_{t}x{nb}x{bs}", imp, k))
    cases.append(("empty_lists", np.zeros((2, 4, 128), np.float32), 5))
    one = np.zeros((1, 1, 1), np.float32)
    one[0, 0, 0] = 2.5
    cases.append(("single_element", one, 1))
    tie = np.zeros((1, 4, 8), np.float32)
    tie[0, :, 3] = 1.0
    cases.append(("theta_tie_boundary", tie, 4))
    for t, nb, bs, k in [(1, 1, 100, 3), (3, 5, 100, 7), (2, 3, 7, 4),
                         (3, 2, 1500, 7)]:
        rng = np.random.default_rng(t * 31 + nb)
        imp = rng.random((t, nb, bs), dtype=np.float32)
        imp *= rng.random((t, nb, bs)) < 0.2
        cases.append((f"bs_{t}x{nb}x{bs}", imp.astype(np.float32),
                      min(k, nb * bs)))
    spill = np.zeros((2, 2, 8), np.float32)
    spill[0, 0, 1] = 3.0
    spill[1, 1, 4] = 1.5
    cases.append(("k_exceeds_positive", spill, 10))
    cases.append(("no_terms", np.zeros((0, 4, 128), np.float32), 5))
    cases.append(("k_above_nb_bs", spill[:, :1, :4].copy(), 10))
    for name, t, nb, bs in SWEEP_EDGES:
        cases.append((name, sweep_edge(t, nb, bs), 10))
    return cases


# the kernel's edges: T past the templated 1..16 (a run-time loop), BS in
# two passes and BS off the warp's 32 lanes of 4, NB off the 8 doc blocks
# of a block (and more blocks than an H100 holds at once), and impacts 4
# bytes off 16-byte alignment (the scalar path; phase 1 places them so on
# the device)
SWEEP_EDGES = [("t17_past_templates", 17, 6, 128),
               ("bs132_two_passes", 3, 5, 132),
               ("bs96_partial_warp", 4, 7, 96),
               ("nb4229_off_block", 2, 4229, 128),
               ("impacts_off_16_bytes", 3, 9, 128)]


def sweep_edge(t: int, nb: int, bs: int) -> np.ndarray:
    rng = np.random.default_rng(t * 1000 + nb * 7 + bs)
    imp = rng.random((t, nb, bs), dtype=np.float32)
    imp *= rng.random((t, nb, bs)) < 0.2
    return imp.astype(np.float32)


def off_16(x, dev):
    """A contiguous copy of ``x`` on ``dev`` whose data pointer is 4 bytes
    past 16-byte alignment."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    buf[1:] = x.reshape(-1).to(dev)
    out = buf[1:].view(x.shape)
    check(out.data_ptr() % 16 != 0, "the offset copy is aligned")
    return out


def phase_kernel_small(dev) -> float:
    import torch
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk,
                                                   bm25_topk_ref, ref)
    worst = 0.0
    rows = []
    for name, imp_np, k in small_cases():
        imp = torch.from_numpy(imp_np)
        imp = off_16(imp, dev) if name.endswith("off_16_bytes") \
            else imp.to(dev)
        bmax = imp.amax(2)
        thetas = [blockmax_threshold(imp, bmax, k)]
        ub = ref.term_sum(bmax)
        if ub.numel() > 1:          # a mid-range θ prunes some blocks
            thetas.append(ub.median().reshape(1))
        for theta in thetas:
            got = blockmax_scores(imp, bmax, theta)
            want = ref.blockmax_scores(imp, bmax, theta)
            host = ref.blockmax_scores(imp.cpu(), bmax.cpu(), theta.cpu())
            check(torch.equal(got, want), f"{name}: sweep differs from the "
                                          f"plain sweep on the card")
            check(torch.equal(got.cpu(), host), f"{name}: sweep differs "
                                                f"from the plain sweep on "
                                                f"the host")
            worst = max(worst, max_err(got, want))
        got_s, got_i = bm25_blockmax_topk(imp, bmax, k)
        kk = min(k, imp.shape[1] * imp.shape[2])
        want_s, want_i = bm25_topk_ref(imp, kk)
        check(torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-6),
              f"{name}: top-k scores differ")
        check(set(got_i[got_s > 0].tolist()) == set(want_i[want_s > 0]
                                                     .tolist()),
              f"{name}: top-k ids differ")
        check(bool(torch.isfinite(got_s).all()), f"{name}: non-finite "
                                                 f"top-k score")
        rows.append(name)
    torch.cuda.synchronize()
    emit("kernel_small", cases=rows, max_abs_err=worst,
         tolerance="sweep bitwise equal; top-k rtol 1e-5 atol 1e-6, "
                   "id sets of positive scores equal")
    return worst


# --------------------------------------------------------------------- #
# phase 2: the main path
# --------------------------------------------------------------------- #
def make_queries(seed: int, n: int):
    from repro_torch.data.synth import _WORDS
    rng = np.random.default_rng(seed + 1)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(1, 9)),
                                replace=False)) for _ in range(n)]


def agrees_with_oracle(got, oracle_top, oracle_all) -> bool:
    """``got`` [(addr, score32)] vs the float64 oracle: equal top-k score
    multisets at TIE_RTOL, and equal id sets up to ties at the boundary
    (every oracle doc clearly above the k-th score is returned; every
    returned doc scores within TIE_RTOL of the oracle's k-th)."""
    if len(got) != len(oracle_top):
        return False
    if not np.allclose(sorted(s for _, s in got),
                       sorted(s for _, s in oracle_top), rtol=TIE_RTOL,
                       atol=0):
        return False
    if not got:
        return True
    kth = oracle_top[-1][1]
    ids = {a for a, _ in got}
    above = {a for a, s in oracle_top if s > kth * (1 + TIE_RTOL)}
    return above <= ids and all(
        oracle_all.get(a, 0.0) >= kth * (1 - TIE_RTOL) for a in ids)


def serve_closed_loop(server, queries, clients: int):
    """Each of ``clients`` threads sends its share of ``queries`` one at a
    time; returns (results in query order, per-query seconds)."""
    results = [None] * len(queries)
    lat = [0.0] * len(queries)
    errors = []

    def client(c):
        try:
            for i in range(c, len(queries), clients):
                t0 = time.perf_counter()
                results[i] = server.query(queries[i], timeout=120)
                lat[i] = time.perf_counter() - t0
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "a client hung")
    if errors:
        raise errors[0]
    return results, lat


def block_impacts(warren, terms, stats):
    from repro_torch.core import build_block_impacts
    with warren:
        bidx = build_block_impacts(warren, terms, block_size=BS, stats=stats)
    imp = np.zeros((len(bidx.term_blocks), bidx.n_blocks, BS), np.float32)
    for ti, tb in enumerate(bidx.term_blocks):
        imp[ti, tb["di"] // BS, tb["di"] % BS] = tb["imp"]
    return bidx, imp


def phase_main_path(dev, bw, flops, n_docs=N_DOCS, n_queries=N_QUERIES,
                    n_oracle=N_ORACLE):
    import torch
    from repro_torch import obs
    from repro_torch.core import (DynamicIndex, Warren, collection_stats,
                                  ingest_documents, score_bm25)
    from repro_torch.data.synth import doc_generator
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk, kernel,
                                                   pruned_fraction, ref)
    from repro_torch.serve import RetrievalServer

    warren = Warren(DynamicIndex())
    t0 = time.perf_counter()
    ingest_documents(warren, doc_generator(SEED, n_docs), batch=256)
    t_ingest = time.perf_counter() - t0
    emit("ingest", docs=n_docs, seconds=t_ingest,
         host_docs_per_s=n_docs / t_ingest)

    queries = make_queries(SEED, n_queries)
    oracle_q = queries[:n_oracle]
    kernel.launches = 0                 # main path starts here
    server = RetrievalServer(warren, k=10, device=dev)
    try:
        serve_closed_loop(server, queries[:16], N_CLIENTS)     # warm-up
        server.timings.reset()
        obs.registry().reset()
        t0 = time.perf_counter()
        dev_res, lat = serve_closed_loop(server, queries, N_CLIENTS)
        wall = time.perf_counter() - t0
        summary = server.timing_summary()
        busy = device_busy(lambda: serve_closed_loop(
            server, queries[:64], N_CLIENTS))
    finally:
        server.close()
    reg = obs.registry()
    phases = {name: reg.histogram("kernel_phase_ms", kernel="bm25_topk",
                                  phase=name).snapshot()
              for name in ("gather", "compute")}
    batch = reg.histogram("serve_batch_size", lo=0.5, hi=1e4,
                          per_decade=40)
    lat_ms = 1e3 * np.asarray(lat)
    emit("serve", device=str(server.device), queries=n_queries,
         clients=N_CLIENTS, wall_s=wall, qps=n_queries / wall,
         p50_ms=float(np.percentile(lat_ms, 50)),
         p95_ms=float(np.percentile(lat_ms, 95)),
         mean_batch=batch.sum / max(batch.count, 1),
         timing_summary=summary,
         gather_p50_ms=phases["gather"]["p50"],
         compute_p50_ms=phases["compute"]["p50"], traced_64_queries=busy)

    # parity: the same queries scored on the host give the same bits
    cpu_server = RetrievalServer(warren, k=10, device="cpu")
    try:
        handles = [cpu_server.batcher.submit(q) for q in queries]
        cpu_res = [h.get(timeout=120) for h in handles]
    finally:
        cpu_server.close()
    same = sum(a == b for a, b in zip(dev_res, cpu_res))
    check(same == n_queries, f"card and host servers differ on "
                             f"{n_queries - same} of {n_queries} queries")
    emit("parity", queries=n_queries, identical=same)

    # oracle: an uncapped server against float64 score_bm25
    with warren:
        stats = collection_stats(warren)
        oracles = [(score_bm25(warren, q, k=10, stats=stats),
                    dict(score_bm25(warren, q, k=stats.n_docs, stats=stats)))
                   for q in oracle_q]
    exact = RetrievalServer(warren, k=10, max_postings=stats.n_docs,
                            device=dev)
    try:
        handles = [exact.batcher.submit(q) for q in oracle_q]
        got = [h.get(timeout=120) for h in handles]
    finally:
        exact.close()
    ok = sum(agrees_with_oracle(g, top, full)
             for g, (top, full) in zip(got, oracles))
    check(ok == n_oracle, f"server disagrees with score_bm25 on "
                          f"{n_oracle - ok} of {n_oracle} queries")
    emit("oracle", queries=n_oracle, agree=ok,
         tolerance=f"score multisets rtol {TIE_RTOL}, id sets up to ties")

    # the block-max kernel on the real index, as the retrieval example runs
    # it: host block-impact layout, device pruned top-10
    kernel_ok = 0
    impacts_seen = []
    for q, (top, full) in zip(oracle_q, oracles):
        bidx, imp_np = block_impacts(warren, q.split(), stats)
        imp = torch.from_numpy(imp_np).to(dev)
        bmax = imp.amax(2)
        s, i = bm25_blockmax_topk(imp, bmax, k=10)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        res = [(int(bidx.doc_starts[d]), float(v))
               for d, v in zip(i, s) if v > 0]
        kernel_ok += agrees_with_oracle(res, top, full)
        impacts_seen.append((imp, bmax))
    torch.cuda.synchronize()
    launches = kernel.launches          # main path ends here
    check(kernel_ok == n_oracle, f"block-max top-10 disagrees with "
                                 f"score_bm25 on {n_oracle - kernel_ok} "
                                 f"queries")
    check(launches >= n_oracle, f"bm25_blockmax launched {launches} times "
                                f"on the main path, expected >= {n_oracle}")

    # the kernel against its plain version at the main path's shapes
    worst = 0.0
    pruned = []
    for imp, bmax in impacts_seen:
        theta = blockmax_threshold(imp, bmax, 10)
        got_sw = blockmax_scores(imp, bmax, theta)
        want_sw = ref.blockmax_scores(imp, bmax, theta)
        check(torch.equal(got_sw, want_sw), "sweep differs from the plain "
                                            "sweep on the real index")
        worst = max(worst, max_err(got_sw, want_sw))
        pruned.append(float(pruned_fraction(bmax, theta)))
    imp, bmax = max(impacts_seen, key=lambda p: p[0].shape[0])
    theta = blockmax_threshold(imp, bmax, 10)
    kept = int((ref.term_sum(bmax) >= theta).sum())
    emit("kernel_real_index", queries=n_oracle, agree=kernel_ok,
         launches=launches, shapes=sorted({tuple(i.shape)
                                           for i, _ in impacts_seen}),
         mean_pruned_fraction=float(np.mean(pruned)), max_abs_err=worst,
         widest_shape=list(imp.shape),
         widest_call_ms=time_cuda(
             lambda: blockmax_scores(imp, bmax, theta)),
         widest_kernel_device_ms=kernel_device_ms(
             lambda: blockmax_scores(imp, bmax, theta), "bm25_blockmax"),
         widest_plain_ms=time_cuda(
             lambda: ref.blockmax_scores(imp, bmax, theta)),
         widest_library_call_ms=time_cuda(lambda: imp.sum(0)),
         widest_library_device_ms=kernel_device_ms(lambda: imp.sum(0),
                                                   "reduce_kernel"),
         widest_bound_ms=sweep_bound(*imp.shape, kept, bw, flops)[0])
    return warren, launches, worst, queries, dev_res


# --------------------------------------------------------------------- #
# phase 3: deployment width
# --------------------------------------------------------------------- #
def deployment_impacts(dev, n_docs: int, t: int = T_DEPLOY):
    """Seeded BM25 impacts [T, NB, BS] over n_docs documents: per-term df
    log-spaced over 0.05 %..20 % of the docs, geometric tf, normal dl
    (mean 56), the repo's BM25 (k1 = 0.9, b = 0.4)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    nb = -(-n_docs // BS)
    dl = torch.normal(56.0, 25.0, (n_docs,), generator=g, device=dev)
    dl = dl.round().clamp_(min=4.0)
    norm = K1 * (1.0 - B + B * dl / dl.mean())
    impacts = torch.zeros((t, nb * BS), dtype=torch.float32, device=dev)
    dfs = []
    for ti, frac in enumerate(np.geomspace(5e-4, 0.2, t)):
        hit = torch.rand(n_docs, generator=g, device=dev) < float(frac)
        u = torch.rand(n_docs, generator=g, device=dev).clamp_(min=1e-7)
        tf = 1.0 + torch.floor(torch.log(u) / np.log(0.3))
        df = int(hit.sum())
        idf = float(np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)))
        imp = idf * tf * (K1 + 1.0) / (tf + norm)
        impacts[ti, :n_docs] = torch.where(hit, imp, torch.zeros_like(imp))
        dfs.append(df)
    impacts = impacts.view(t, nb, BS)
    return impacts, impacts.amax(2).contiguous(), dfs


def blockmax_plan(impacts) -> dict:
    """bm25_blockmax's launch plan for these impacts (its output is
    aligned)."""
    from repro_torch.kernels.bm25_blockmax import kernel
    return kernel.plan(*impacts.shape,
                       impacts.data_ptr() % 16 == 0)._asdict()


def phase_deployment(dev, bw, flops):
    import torch
    from repro_torch.core.vectorized import bm25_topk
    from repro_torch.kernels.bm25_blockmax import (blockmax_scores,
                                                   blockmax_threshold,
                                                   bm25_blockmax_topk,
                                                   bm25_topk_ref, ref)
    t0 = time.perf_counter()
    impacts, bmax, dfs = deployment_impacts(dev, MSMARCO_PASSAGES)
    torch.cuda.synchronize()
    t, nb, bs = impacts.shape
    emit("deploy_data", shape=[t, nb, bs], dfs=dfs,
         impacts_mb=impacts.numel() * 4 / 1e6,
         block_max_mb=bmax.numel() * 4 / 1e6,
         output_mb=nb * bs * 4 / 1e6, seconds=time.perf_counter() - t0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ub = ref.term_sum(bmax)
    rows = {}
    worst = 0.0
    for k in (10, 1000):
        theta = blockmax_threshold(impacts, bmax, k)
        kept = int((ub >= theta).sum())
        got = blockmax_scores(impacts, bmax, theta)
        want = ref.blockmax_scores(impacts, bmax, theta)
        check(torch.equal(got, want), f"k={k}: sweep differs from the plain "
                                      f"sweep at deployment width")
        worst = max(worst, max_err(got, want))
        del got, want
        got_s, got_i = bm25_blockmax_topk(impacts, bmax, k)
        want_s, want_i = bm25_topk_ref(impacts, k)
        bitwise = bool(torch.equal(got_s, want_s)
                       and torch.equal(got_i, want_i))
        check(torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
              and set(got_i[got_s > 0].tolist())
              == set(want_i[want_s > 0].tolist()),
              f"k={k}: pruned top-k differs from the exhaustive top-k")
        # the kernel and the one library call in turns (A B B A)
        calls = {"kernel": lambda: blockmax_scores(impacts, bmax, theta),
                 "library": lambda: impacts.sum(0)}
        ms, turns = time_in_turns(calls, flush=flush.zero_)
        device_ms = kernel_device_ms(calls["kernel"], "bm25_blockmax_kernel")
        plain_ms = time_cuda(
            lambda: ref.blockmax_scores(impacts, bmax, theta),
            flush=flush.zero_)
        topk_ms = time_cuda(lambda: bm25_blockmax_topk(impacts, bmax, k),
                            flush=flush.zero_)
        bound_ms, bound_by, nbytes = sweep_bound(t, nb, bs, kept, bw, flops)
        rows[k] = dict(k=k, theta=float(theta), pruned_fraction=1 - kept / nb,
                       blocks_kept=kept, kernel_ms=ms["kernel"],
                       library_ms=ms["library"], turns_ms=turns,
                       kernel_over_library=ms["kernel"] / ms["library"],
                       kernel_device_ms=device_ms, plain_ms=plain_ms,
                       library_call="impacts.sum(0) (no pruning)",
                       bound_ms=bound_ms, bound_by=bound_by,
                       share_of_bound=bound_ms / ms["kernel"],
                       bytes=nbytes, topk_ms=topk_ms,
                       topk_bitwise_equal_to_exhaustive=bitwise,
                       plan=blockmax_plan(impacts))
        emit("deploy_blockmax", **rows[k])
    del impacts, bmax, flush

    # the dense scorer at the server's accumulator width for this doc space
    q, tt, l = 16, 8, 4096
    n_acc = 1 << (MSMARCO_PASSAGES - 1).bit_length()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    start = torch.randint(0, MSMARCO_PASSAGES, (q, tt, 1), generator=g,
                          device=dev)
    stride = torch.randint(1, MSMARCO_PASSAGES // l, (q, tt, 1),
                           generator=g, device=dev)
    doc_idx = ((start + stride * torch.arange(l, device=dev))
               % MSMARCO_PASSAGES).to(torch.int32)
    imp = torch.rand((q, tt, l), generator=g, device=dev) * 3.0
    qmask = torch.ones((q, tt), device=dev)
    a = bm25_topk(doc_idx, imp, qmask, n_docs=n_acc, k=10)
    b = bm25_topk(doc_idx, imp, qmask, n_docs=n_acc, k=10)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "dense bm25_topk is not deterministic on the card")
    dense_ms = time_cuda(lambda: bm25_topk(doc_idx, imp, qmask,
                                           n_docs=n_acc, k=10), n=10)
    emit("deploy_dense", shape=[q, tt, l], accumulator=n_acc,
         ms=dense_ms, deterministic=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return rows, worst


# --------------------------------------------------------------------- #
# phase 4: interval_join against its plain version at small shapes
# --------------------------------------------------------------------- #
JOIN_MODES = ("contained_in", "containing")


def random_gc_list(rng, n: int, span: int):
    """(starts, ends) of a G-reduced list drawn as the kernel tests draw
    theirs: n distinct starts in [0, span), lengths below 50."""
    from repro_torch.core.annotation import reduce_minimal
    starts = np.sort(rng.choice(span, size=n, replace=False)).astype(np.int64)
    ends = starts + rng.integers(0, 50, size=n)
    lst = reduce_minimal(starts, ends, np.zeros(n))
    return lst.starts, lst.ends


def join_window_lists(seed: int, mode: str, w: int, na: int = 2048,
                      nb: int = 2000, first: int = 500):
    """A (``na`` entries) and a GC-list B (``nb``) whose window for A —
    B[lo .. min(hi, NB-1)], lo and hi the lower bounds of A's least and
    greatest probe key (a_e for contained_in, a_s for containing) in B's —
    holds exactly ``w`` entries, from B[first].  Starts and ends strictly
    increase in B; A's keys lie between B[first]'s and B[first + w - 1]'s,
    both included, and about half of A meets its candidate."""
    rng = np.random.default_rng(seed)
    b_s = np.arange(nb, dtype=np.int64) * 10 + rng.integers(0, 3, nb)
    b_e = b_s + rng.integers(2, 9, nb)
    contained = mode == "contained_in"
    bkey = b_e if contained else b_s
    lo, hi = bkey[first], bkey[first + w - 1]
    keys = np.sort(np.concatenate([[lo, hi],
                                   rng.integers(lo, hi + 1, na - 2)]))
    if contained:
        a = (keys - rng.integers(0, 12, na), keys)
    else:
        a = (keys, keys + rng.integers(0, 20, na))
    return a, (b_s, b_e)


def pad_gaps(a, seed: int):
    """A as a combination operator leaves it before ``compact``:
    ``one_of``'s G-reduced candidates in start order, the dropped ones PAD
    in place."""
    import torch
    from repro_torch.core.vectorized import one_of
    rng = np.random.default_rng(seed)
    shift = rng.integers(0, 3, len(a[0]))
    s, e = one_of(*(torch.from_numpy(np.asarray(x, np.int32)) for x in (
        *a, a[0] + shift, a[1] + shift + rng.integers(0, 30, len(a[0])))))
    return s.numpy().astype(np.int64), e.numpy().astype(np.int64)


# cases that put the kernel's first tile on each path (join_small_cases'
# last field): the window one under, at and one over the budget in each
# mode, an A in no order and a sparse A over a dense B (the wide tiles'
# kernel), an A with PAD gaps, an all-PAD A (nothing to search), and A or
# B 4 bytes off 16-byte alignment (scalar loads; 4-byte copies of B)
JOIN_PATH_CASES = [
    *(f"window_{side}_budget_{mode}" for mode in JOIN_MODES
      for side in ("under", "at", "over")),
    "a_in_no_order_over_large_b", "sparse_a_over_dense_b", "a_with_pad_gaps",
    "all_pad_a", "a_off_16_bytes", "b_off_16_bytes"]


def join_small_cases():
    """(name, A, B, modes, the first tile's path or None) with A and B as
    (starts, ends), from fixed seeds: the kernel tests' sweep, empty lists,
    single elements, lengths off the tile, an A in no order, and
    JOIN_PATH_CASES at the wrapper's plan's budget."""
    from repro_torch.kernels.interval_join.kernel import BUDGET
    both = tuple(JOIN_MODES)
    cases = []
    for na, nb in [(16, 16), (100, 37), (513, 257), (1000, 3)]:
        rng = np.random.default_rng(na * 1000 + nb)
        cases.append((f"sweep_{na}x{nb}", random_gc_list(rng, na, 10_000),
                      random_gc_list(rng, nb, 10_000), both, None))
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    one = (np.array([5]), np.array([9]))
    cases += [("empty_a", empty, one, both, None),
              ("empty_b", one, empty, both, None),
              ("empty_both", empty, empty, both, None)]
    for a, b in [((5, 9), (4, 10)), ((4, 10), (5, 9)), ((5, 9), (5, 9)),
                 ((5, 9), (20, 30))]:
        cases.append((f"single_{a[0]}_{a[1]}_in_{b[0]}_{b[1]}",
                      (np.array([a[0]]), np.array([a[1]])),
                      (np.array([b[0]]), np.array([b[1]])), both, None))
    for na, nb in [(13, 5), (20, 17), (1, 9), (257, 3), (4099, 771)]:
        rng = np.random.default_rng(na * 100 + nb)
        cases.append((f"ragged_{na}x{nb}", random_gc_list(rng, na, 60_000),
                      random_gc_list(rng, nb, 60_000), both, None))
    rng = np.random.default_rng(11)
    a_s, a_e = random_gc_list(rng, 5000, 60_000)
    perm = rng.permutation(len(a_s))
    cases.append(("a_in_no_order", (a_s[perm], a_e[perm]),
                  random_gc_list(rng, 700, 60_000), both, None))

    for mode in JOIN_MODES:
        for side, delta, path in [("under", -1, "staged"), ("at", 0, "staged"),
                                  ("over", 1, "device")]:
            a, b = join_window_lists(BUDGET + delta, mode, BUDGET + delta)
            cases.append((f"window_{side}_budget_{mode}", a, b, (mode,),
                          path))
    rng = np.random.default_rng(12)
    a_s, a_e = random_gc_list(rng, 3000, 10 ** 6)
    perm = rng.permutation(len(a_s))
    cases += [
        ("a_in_no_order_over_large_b", (a_s[perm], a_e[perm]),
         random_gc_list(rng, 20_000, 10 ** 6), both, "device"),
        ("sparse_a_over_dense_b", random_gc_list(rng, 300, 10 ** 6),
         random_gc_list(rng, 30_000, 10 ** 6), both, "device")]
    a, b = join_window_lists(13, "contained_in", 600, na=2000)
    cases.append(("a_with_pad_gaps", pad_gaps(a, 13), b, both, None))
    pad = np.full(3000, int(2 ** 31 - 1), np.int64)
    cases.append(("all_pad_a", (pad, pad), b, both, "none"))
    rng = np.random.default_rng(14)
    cases += [(f"{side}_off_16_bytes", random_gc_list(rng, 3000, 60_000),
               random_gc_list(rng, 900, 60_000), both, None)
              for side in ("a", "b")]
    assert [c[0] for c in cases[-len(JOIN_PATH_CASES):]] == JOIN_PATH_CASES
    return cases


def dense_join(a, b, mode: str) -> np.ndarray:
    """The dense definition, every pair compared: int32 mask over A."""
    a_s, a_e = (np.asarray(x, np.int64)[:, None] for x in a)
    b_s, b_e = (np.asarray(x, np.int64)[None, :] for x in b)
    if mode == "contained_in":
        hit = (b_s <= a_s) & (a_e <= b_e)
    else:
        hit = (a_s <= b_s) & (b_e <= a_e)
    return hit.any(axis=1).astype(np.int32)


def join_paths(a_s, a_e, b_s, b_e, mode: str, counts=None) -> dict:
    """The tiles' paths under the wrapper's plan, from the lists
    (``kernel.tile_paths``); checked equal to the kernel's own ``counts``
    where it ran (int32 [3]: staged, device memory, none)."""
    from repro_torch.kernels.interval_join import kernel as join_kernel
    p = join_kernel.plan(a_s.shape[0], b_s.shape[0], True)
    paths = join_kernel.tile_paths(a_s, a_e, b_s, b_e, mode, p)
    paths["budget"] = p.budget
    if counts is not None:
        got = dict(zip(("staged", "device", "none"), counts.tolist()))
        check(got == {k: paths[k] for k in got},
              f"the kernel's tiles by path {got} differ from tile_paths' "
              f"{ {k: paths[k] for k in got} }")
    return paths


def phase_join_small(dev) -> int:
    import torch
    from repro_torch.core.vectorized import pack
    from repro_torch.kernels.interval_join import interval_join, ref
    on_card = torch.device(dev).type == "cuda"
    tail = 3                    # PAD entries after every list
    mismatches = 0
    names = []
    tiles = {"staged": 0, "device": 0, "none": 0}
    for name, a, b, modes, first_path in join_small_cases():
        a_s, a_e, _ = pack(a[0], a[1], size=len(a[0]) + tail, device=dev)
        b_s, b_e, _ = pack(b[0], b[1], size=len(b[0]) + tail, device=dev)
        if name == "a_off_16_bytes":
            a_s, a_e = off_16(a_s, dev), off_16(a_e, dev)
        if name == "b_off_16_bytes":
            b_s, b_e = off_16(b_s, dev), off_16(b_e, dev)
        for mode in modes:
            counts = (torch.zeros(3, dtype=torch.int32, device=dev)
                      if on_card else None)
            got = interval_join(a_s, a_e, b_s, b_e, mode=mode, counts=counts)
            want = ref.MODES[mode](a_s, a_e, b_s, b_e)
            host = ref.MODES[mode](a_s.cpu(), a_e.cpu(), b_s.cpu(), b_e.cpu())
            dense = np.concatenate([dense_join(a, b, mode),
                                    np.zeros(tail, np.int32)])
            bad = (int((got != want).sum()) + int((got.cpu() != host).sum())
                   + int((got.cpu().numpy() != dense).sum()))
            check(got.dtype == torch.int32 and bad == 0,
                  f"{name}/{mode}: {bad} mismatches against the plain join")
            mismatches += bad
            paths = join_paths(a_s, a_e, b_s, b_e, mode, counts)
            for k in tiles:
                tiles[k] += paths[k]
            if first_path is not None:
                w = int(paths["windows"][0])
                path = ("none" if w < 0 else "staged"
                        if w <= paths["budget"] else "device")
                check(path == first_path, f"{name}/{mode}: the first tile's "
                                          f"window of {w} takes the {path} "
                                          f"path, not {first_path}")
            # a zero-length B matches nothing; a zero-length A launches
            # nothing
            got = interval_join(a_s, a_e, b_s[:0], b_e[:0], mode=mode)
            check(not bool(got.any()), f"{name}/{mode}: hit in an empty B")
            check(interval_join(a_s[:0], a_e[:0], b_s, b_e,
                                mode=mode).numel() == 0,
                  f"{name}/{mode}: output for an empty A")
        names.append(name)
    _sync(dev)
    emit("join_small", cases=names, modes=list(JOIN_MODES),
         mismatches=mismatches, tiles=tiles,
         tiles_from="the kernel's counts, equal to tile_paths" if on_card
         else "tile_paths (no kernel on the CPU)",
         tolerance="exact: kernel == plain on the card == plain on the host "
                   "== the dense all-pairs definition")
    return mismatches


# --------------------------------------------------------------------- #
# phases 5-6: structured queries, lazy host engine vs the card
# --------------------------------------------------------------------- #
def _expected_launches(dev, joins: int) -> int:
    """One launch per containment operator on the card; none on the CPU,
    where the wrapper takes the plain version."""
    import torch
    return joins if torch.device(dev).type == "cuda" else 0


class DeviceAlgebra:
    """Queries composed by hand from the vectorized operators on one
    device, as ``benchmarks/json_queries.py`` composes lazy nodes: leaves
    from ``reader.annotations``, phrases from ``Phrase.to_list()``.
    Every list is (starts, ends, float64 values) in the vectorized layout;
    ``joins`` counts the containment operators run."""

    def __init__(self, reader, dev):
        from repro_torch.core import vectorized
        self.V = vectorized
        self.reader, self.dev, self.joins = reader, dev, 0

    def _pack(self, lst):
        import torch
        s, e, _ = self.V.pack(lst.starts, lst.ends, device=self.dev)
        v = np.zeros(s.shape[0])
        v[:len(lst)] = lst.values
        return s, e, torch.from_numpy(v).to(self.dev)

    def leaf(self, feature: str):
        return self._pack(self.reader.annotations(feature))

    def phrase(self, text: str):
        return self._pack(self.reader.phrase(text).to_list())

    def _contain(self, op, a, b):
        self.joins += 1
        return op(*a, *b[:2])

    def contained_in(self, a, b):
        return self._contain(self.V.contained_in, a, b)

    def containing(self, a, b):
        return self._contain(self.V.containing, a, b)

    def not_contained_in(self, a, b):
        return self._contain(self.V.not_contained_in, a, b)

    def not_containing(self, a, b):
        return self._contain(self.V.not_containing, a, b)

    def _combine(self, op, a, b):
        """A combination operator's output, compacted into a GC-list so
        that a containment operator may take it as B."""
        import torch
        s, e = self.V.compact(*op(a[0], a[1], b[0], b[1]))
        return s, e, torch.zeros(s.shape, dtype=torch.float64,
                                 device=s.device)

    def both_of(self, a, b):
        return self._combine(self.V.both_of, a, b)

    def one_of(self, a, b):
        return self._combine(self.V.one_of, a, b)

    def followed_by(self, a, b):
        return self._combine(self.V.followed_by, a, b)

    def spans(self, lst):
        """[(p, q)] of a packed list's valid entries, in start order."""
        s, e, _ = self.V.unpack(lst[0], lst[1])
        return list(zip(s.tolist(), e.tolist()))


def structured_queries():
    """(query text, its hand composition): every operator of the query
    language, over the Zipf tail of the main path's vocabulary (a phrase
    of two tail words would rarely occur)."""
    return [
        ("[:] >> amplitude",
         lambda d: d.containing(d.leaf(":"), d.leaf("amplitude"))),
        ("[:] !>> resonance",
         lambda d: d.not_containing(d.leaf(":"), d.leaf("resonance"))),
        ('"school state" << [:]',
         lambda d: d.contained_in(d.phrase("school state"), d.leaf(":"))),
        ("(damping & frequency) << [:]",
         lambda d: d.contained_in(d.both_of(d.leaf("damping"),
                                            d.leaf("frequency")),
                                  d.leaf(":"))),
        ("(conductor ... vibration) << [:]",
         lambda d: d.contained_in(d.followed_by(d.leaf("conductor"),
                                                d.leaf("vibration")),
                                  d.leaf(":"))),
        ("[:] >> (transmission | amplitude)",
         lambda d: d.containing(d.leaf(":"),
                                d.one_of(d.leaf("transmission"),
                                         d.leaf("amplitude")))),
        ("conductor !<< ([:] >> resonance)",
         lambda d: d.not_contained_in(d.leaf("conductor"),
                                      d.containing(d.leaf(":"),
                                                   d.leaf("resonance")))),
        ("(amplitude ... resonance) !<< [:]",
         lambda d: d.not_contained_in(d.followed_by(d.leaf("amplitude"),
                                                    d.leaf("resonance")),
                                      d.leaf(":"))),
    ]


def phase_structured(dev, warren) -> int:
    from repro_torch.core.query import solve
    from repro_torch.kernels.interval_join import kernel as join_kernel
    rows = []
    with warren:
        lazy = {}
        for text, _ in structured_queries():
            t0 = time.perf_counter()
            lazy[text] = [(p, q) for p, q, _ in solve(text, warren,
                                                      limit=1 << 62)]
            rows.append({"query": text, "solutions": len(lazy[text]),
                         "lazy_ms": 1e3 * (time.perf_counter() - t0)})
        d = DeviceAlgebra(warren, dev)
        join_kernel.launches = 0            # the slice's main path
        for row, (text, compose) in zip(rows, structured_queries()):
            t0 = time.perf_counter()
            got = d.spans(compose(d))
            row["device_ms"] = 1e3 * (time.perf_counter() - t0)
            check(got == lazy[text], f"{text}: the card's {len(got)} "
                                     f"solutions differ from the lazy "
                                     f"engine's {len(lazy[text])}")
        _sync(dev)
        launches = join_kernel.launches     # ends here
    check(sum(r["solutions"] for r in rows) > 0, "no query has a solution")
    check(d.joins > 0 and launches == _expected_launches(dev, d.joins),
          f"interval_join launched {launches} times for {d.joins} "
          f"containment operators")
    emit("structured", queries=rows, launches=launches,
         containment_operators=d.joins, mismatches=0)
    return launches


DATE_PATHS = [":created:", ":created_at:$date:", ":date:"]


def build_json_warren(scale: float):
    """The port's JSON store over ``json_collection(seed=0, scale)``, dates
    annotated post hoc: (warren, objects, dated fields)."""
    from repro_torch.core import (DynamicIndex, Warren, add_json,
                                  annotate_dates)
    from repro_torch.data.synth import json_collection
    w = Warren(DynamicIndex())
    data = json_collection(seed=0, scale=scale)
    with w:
        w.transaction()
        for name, objs in data.items():
            for obj in objs:
                add_json(w, obj, collection=f"Files/{name}.json")
        w.commit()
    with w:
        w.transaction()
        dated = annotate_dates(w, DATE_PATHS)
        w.commit()
    return w, sum(len(v) for v in data.values()), dated


def _group_count(reader, spans) -> int:
    """Fig. 6 query 6's GROUP BY: distinct result words over the spans."""
    groups = {}
    for p, q in spans:
        toks = reader.tokens(int(p), int(q))
        key = " ".join(t for t in toks if len(t) > 1) if toks else "?"
        groups[key] = groups.get(key, 0) + 1
    return len(groups)


def _stats(vals):
    return (min(vals), sum(vals) / len(vals), max(vals))


def fig6_lazy(reader):
    """The paper's Fig. 6 queries on the port's lazy engine, as
    ``benchmarks/json_queries.py`` writes them: (name, fn) pairs."""
    from repro_torch.core.gcl import (BothOf, ContainedIn, Containing, OneOf,
                                      Phrase, Term)

    def h(f):
        return Term(reader.annotations(f))

    def phrase(text):
        terms = [h(t) for t in text.split()]
        return terms[0] if len(terms) == 1 else Phrase(terms)

    def n(node):
        return len(node.solutions())

    return [
        ("1 restaurant rating stats", lambda: _stats(
            [v for _, _, v in ContainedIn(
                h(":rating:"), h("Files/restaurant.json")).solutions()])),
        ("2 zips in New York", lambda: n(ContainedIn(
            Containing(h(":city:"), phrase("new york")),
            h("Files/zips.json")))),
        ("3 nanotech company names", lambda: n(ContainedIn(
            h(":name:"), Containing(
                h("Files/companies.json"),
                ContainedIn(Containing(h(":category_code:"),
                                       phrase("nanotech")),
                            h("Files/companies.json")))))),
        ("4 book titles+authors", lambda: n(ContainedIn(
            OneOf(h(":title:"), h(":authors:")), h("Files/books.json")))),
        ("5 count trades", lambda: n(ContainedIn(h(":"),
                                                 h("Files/trades.json")))),
        ("6 inspections GROUP BY result", lambda: _group_count(
            reader, [(p, q) for p, q, _ in ContainedIn(
                h(":result:"),
                h("Files/city_inspections.json")).solutions()])),
        ("7 count all objects", lambda: len(reader.annotations(":"))),
        ("8 books published 2008", lambda: n(ContainedIn(
            h(":title:"), Containing(h("Files/books.json"),
                                     h("year=2008"))))),
        ("9 objects created 2008-06", lambda: n(Containing(
            h(":"), BothOf(h("year=2008"), h("month=06"))))),
    ]


def fig6_device(d: DeviceAlgebra):
    """The same nine queries composed on ``d``'s device."""
    from repro_torch.core.vectorized import PAD, unpack

    def n(lst):
        return int((lst[0] != int(PAD)).sum())

    return [
        ("1 restaurant rating stats", lambda: _stats(unpack(*d.contained_in(
            d.leaf(":rating:"), d.leaf("Files/restaurant.json")))[2]
            .tolist())),
        ("2 zips in New York", lambda: n(d.contained_in(
            d.containing(d.leaf(":city:"), d.phrase("new york")),
            d.leaf("Files/zips.json")))),
        ("3 nanotech company names", lambda: n(d.contained_in(
            d.leaf(":name:"), d.containing(
                d.leaf("Files/companies.json"),
                d.contained_in(d.containing(d.leaf(":category_code:"),
                                            d.phrase("nanotech")),
                               d.leaf("Files/companies.json")))))),
        ("4 book titles+authors", lambda: n(d.contained_in(
            d.one_of(d.leaf(":title:"), d.leaf(":authors:")),
            d.leaf("Files/books.json")))),
        ("5 count trades", lambda: n(d.contained_in(
            d.leaf(":"), d.leaf("Files/trades.json")))),
        ("6 inspections GROUP BY result", lambda: _group_count(
            d.reader, d.spans(d.contained_in(
                d.leaf(":result:"), d.leaf("Files/city_inspections.json"))))),
        ("7 count all objects", lambda: n(d.leaf(":"))),
        ("8 books published 2008", lambda: n(d.contained_in(
            d.leaf(":title:"), d.containing(d.leaf("Files/books.json"),
                                            d.leaf("year=2008"))))),
        ("9 objects created 2008-06", lambda: n(d.containing(
            d.leaf(":"), d.both_of(d.leaf("year=2008"),
                                   d.leaf("month=06"))))),
    ]


def phase_json(dev, scale: float = JSON_SCALE) -> int:
    from repro_torch.core.gcl import ContainedIn, Term
    from repro_torch.core.vectorized import unpack
    from repro_torch.kernels.interval_join import kernel as join_kernel
    t0 = time.perf_counter()
    warren, n_objects, dated = build_json_warren(scale)
    t_ingest = time.perf_counter() - t0
    rows = []
    with warren:
        d = DeviceAlgebra(warren, dev)
        before = join_kernel.launches
        for (name, lazy_fn), (_, dev_fn) in zip(fig6_lazy(warren),
                                                fig6_device(d)):
            t0 = time.perf_counter()
            want = lazy_fn()
            t1 = time.perf_counter()
            got = dev_fn()
            _sync(dev)
            rows.append({"query": name, "result": got,
                         "lazy_ms": 1e3 * (t1 - t0),
                         "device_ms": 1e3 * (time.perf_counter() - t1)})
            check(got == want, f"{name}: card {got} != lazy {want}")
        # query 1's values, bit for bit
        lazy_vals = np.array([v for _, _, v in ContainedIn(
            Term(warren.annotations(":rating:")),
            Term(warren.annotations("Files/restaurant.json"))).solutions()])
        dev_vals = unpack(*d.contained_in(
            d.leaf(":rating:"), d.leaf("Files/restaurant.json")))[2]
        check(lazy_vals.dtype == dev_vals.dtype == np.float64
              and np.array_equal(lazy_vals.view(np.int64),
                                 dev_vals.view(np.int64)),
              "query 1's values differ between the card and the lazy engine")
        _sync(dev)
        launches = join_kernel.launches - before
    check(launches == _expected_launches(dev, d.joins),
          f"interval_join launched {launches} times for {d.joins} "
          f"containment operators")
    emit("json", scale=scale, objects=n_objects, dated_fields=dated,
         ingest_s=t_ingest, host_objects_per_s=n_objects / t_ingest,
         queries=rows, q1_values=len(lazy_vals), launches=launches,
         mismatches=0)
    return launches


# --------------------------------------------------------------------- #
# phase 7: interval_join at deployment width
# --------------------------------------------------------------------- #
def passage_space(dev, g, n_passages: int = MSMARCO_PASSAGES):
    """MS MARCO v1 passage's doc space laid back to back, one separator
    token after each passage; lengths from a seeded normal (mean 56, as
    phase 3's dl), at least 1.  Returns passage (starts, ends) int32 and
    the token count."""
    import torch
    lens = torch.normal(56.0, 25.0, (n_passages,), generator=g, device=dev)
    lens = lens.round_().clamp_(min=1.0).to(torch.int64)
    starts = torch.cumsum(lens + 1, 0) - (lens + 1)
    ends = starts + lens - 1
    tokens = int(ends[-1]) + 2
    check(tokens < 2 ** 31 - 1, f"{tokens} tokens overflow int32 addresses")
    return starts.to(torch.int32), ends.to(torch.int32), tokens


def term_occurrences(dev, g, tokens: int, rate: float):
    """Sorted int32 addresses of a term that takes ``rate`` of all
    tokens."""
    import torch
    hit = torch.rand(tokens, generator=g, device=dev) < rate
    return hit.nonzero().squeeze(1).to(torch.int32)


def oracle_contained_in(pos, p_s, p_e, selected) -> np.ndarray:
    """Host oracle for J1: a token is contained iff it lies inside a
    passage (its owner, by np.searchsorted over all passages) that is
    selected."""
    owner = np.maximum(np.searchsorted(p_s, pos, side="right") - 1, 0)
    return ((pos >= p_s[owner]) & (pos <= p_e[owner])
            & selected[owner]).astype(np.int32)


def oracle_containing(p_s, p_e, occ) -> np.ndarray:
    """Host oracle for J2: a passage contains an occurrence iff some
    occurrence address lies in [start, end] (two np.searchsorted)."""
    return (np.searchsorted(occ, p_e, side="right")
            > np.searchsorted(occ, p_s, side="left")).astype(np.int32)


def join_bound(na: int, nb: int, bw: float, flops: float):
    """(bound_ms, bound_by, bytes): each list read once and the mask
    written once, 4·(2·NA + 2·NB + NA) bytes, over the memory rate; or
    NA·⌈log2(NB+1)⌉ compares over the float32 rate, if that is larger."""
    nbytes = 4 * (2 * na + 2 * nb + na)
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * na * int(np.ceil(np.log2(nb + 1))) / flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def deploy_join_cases(dev, n_passages: int):
    """J1 and J2 over the passage space, made on ``dev`` from the seed, and
    J1 again with A in no order and with A 4 bytes off 16-byte alignment:
    {name: (mode, A, B, host oracle)}.  A single-token interval's start and
    end are equal but lie in separate buffers, as ``pack`` lays them out,
    so the kernel reads both."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    p_s, p_e, tokens = passage_space(dev, g, n_passages)
    selected = torch.rand(p_s.shape[0], generator=g, device=dev) < 0.30
    j1 = term_occurrences(dev, g, tokens, 0.05)
    j2 = term_occurrences(dev, g, tokens, 0.005)
    perm = torch.randperm(j1.shape[0], generator=g, device=dev)
    h = {k: x.cpu().numpy() for k, x in (("p_s", p_s), ("p_e", p_e),
                                          ("sel", selected), ("j1", j1),
                                          ("j2", j2), ("perm", perm))}
    j1_b = (p_s[selected], p_e[selected])
    return tokens, {
        "J1": ("contained_in", (j1, j1.clone()), j1_b,
               lambda: oracle_contained_in(h["j1"], h["p_s"], h["p_e"],
                                           h["sel"])),
        "J2": ("containing", (p_s, p_e), (j2, j2.clone()),
               lambda: oracle_containing(h["p_s"], h["p_e"], h["j2"])),
        "J1_no_order": ("contained_in", (j1[perm], j1[perm]), j1_b,
                        lambda: oracle_contained_in(h["j1"][h["perm"]],
                                                    h["p_s"], h["p_e"],
                                                    h["sel"])),
        "J1_off_16": ("contained_in", (off_16(j1, dev), off_16(j1, dev)),
                      j1_b,
                      lambda: oracle_contained_in(h["j1"], h["p_s"],
                                                  h["p_e"], h["sel"])),
    }


def phase_deploy_join(dev, bw, flops, n_passages: int = MSMARCO_PASSAGES):
    import torch
    from repro_torch.core import vectorized as V
    from repro_torch.kernels.interval_join import interval_join, ref
    t0 = time.perf_counter()
    tokens, cases = deploy_join_cases(dev, n_passages)
    _sync(dev)
    emit("deploy_join_data", passages=n_passages, tokens=tokens,
         seconds=time.perf_counter() - t0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for name, (mode, (a_s, a_e), (b_s, b_e), oracle) in cases.items():
        na, nb = a_s.shape[0], b_s.shape[0]
        check(len({x.data_ptr() for x in (a_s, a_e, b_s, b_e)}) == 4,
              f"{name}: two of the lists share a buffer, which the byte "
              f"bound does not count")
        counts = (torch.zeros(3, dtype=torch.int32, device=dev)
                  if torch.device(dev).type == "cuda" else None)
        got = interval_join(a_s, a_e, b_s, b_e, mode=mode, counts=counts)
        want = ref.MODES[mode](a_s, a_e, b_s, b_e)
        vs_plain = int((got != want).sum())
        vs_oracle = int((got.cpu().numpy() != oracle()).sum())
        check(vs_plain == 0 and vs_oracle == 0,
              f"{name}: {vs_plain} mismatches against the plain join, "
              f"{vs_oracle} against the host oracle")
        paths = join_paths(a_s, a_e, b_s, b_e, mode, counts)
        tiles = {k: paths[k] for k in ("staged", "device", "none")}
        valid_tiles = tiles["staged"] + tiles["device"]
        if name in ("J1", "J2"):        # sorted: every valid tile staged
            check(valid_tiles > 0 and tiles["staged"] == valid_tiles,
                  f"{name}: {tiles['device']} of {valid_tiles} valid tiles "
                  f"left the shared-memory path")
        a_v = torch.zeros(na, dtype=torch.float32, device=dev)
        op = V.contained_in if mode == "contained_in" else V.containing
        probe, keys = (b_e, a_e) if mode == "contained_in" else (b_s, a_s)
        turns_ms, turns = time_in_turns({
            "kernel": lambda: interval_join(a_s, a_e, b_s, b_e, mode=mode),
            "library": lambda: torch.searchsorted(probe, keys)},
            flush=flush.zero_)
        plain_ms = time_cuda(lambda: ref.MODES[mode](a_s, a_e, b_s, b_e),
                             flush=flush.zero_)
        operator_ms = time_cuda(lambda: op(a_s, a_e, a_v, b_s, b_e),
                                flush=flush.zero_)
        bound_ms, bound_by, nbytes = join_bound(na, nb, bw, flops)
        side = "ends" if mode == "contained_in" else "starts"
        kernel_ms = turns_ms["kernel"]
        rows[name] = dict(
            mode=mode, shape=[na, nb], hits=int(got.sum()),
            mismatches=vs_plain + vs_oracle, tiles=tiles,
            valid_tiles=valid_tiles, budget=paths["budget"],
            kernel_ms=kernel_ms, kernel_turns=turns["kernel"],
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            share_of_bound=bound_ms / kernel_ms, plain_ms=plain_ms,
            library_ms=turns_ms["library"], library_turns=turns["library"],
            library_call=f"torch.searchsorted of A's {side} in B's {side} "
                         f"(nearest call; computes no mask)",
            kernel_over_library=kernel_ms / turns_ms["library"],
            operator_ms=operator_ms,
            kernel_share_of_operator=kernel_ms / operator_ms)
        emit("deploy_join", case=name, **rows[name])
    del flush, cases
    _sync(dev)
    return rows


# --------------------------------------------------------------------- #
# phases 8-9: sharded, replicated and tiered serving
# --------------------------------------------------------------------- #
def doc_texts(warren, addrs) -> dict:
    """{document start address: its text} for the addresses given, read
    through a clone, so no server's session on ``warren`` is disturbed."""
    warren = warren.clone()
    with warren:
        docs = warren.annotations(":")
        ends = dict(zip(docs.starts.tolist(), docs.ends.tolist()))
        return {a: warren.translate(a, ends[a]) for a in addrs}


def tie_groups(rows, texts):
    """[(score rounded to 9 places, frozenset of texts)], one entry for each
    run of equal scores — how two warrens whose addresses differ by design
    (striped shard ranges against one sequential index) are compared."""
    pairs = [(round(s, 9), texts[a]) for a, s in rows]
    out, i = [], 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][0] == pairs[i][0]:
            j += 1
        out.append((pairs[i][0], frozenset(t for _, t in pairs[i:j])))
        i = j
    return out


def cap_binds(warren, queries, cap: int) -> list:
    """For each query: does one of its terms (as the server picks them)
    have more postings than ``cap``?"""
    from repro_torch.core import ranking
    w = warren.clone()
    with w:
        return [any(len(w.annotations(ranking.TF_PREFIX
                                      + ranking.porter_stem(t))) > cap
                    for t in list(dict.fromkeys(
                        ranking.ranking_tokens(q)))[:MAX_TERMS])
                for q in queries]


def against_single(sharded, got_rows, single, want_rows, queries, dev,
                   k: int = 10, cap: int = 4096) -> dict:
    """Hold sharded rows against the single index's rows for the same
    queries by (rounded score, text), tie groups as sets.

    The posting cap keeps a term's ``cap`` highest impacts, equal impacts
    in address order, and the two address orders differ by design
    (striped shard ranges against one sequential index): where a query's
    term has more than ``cap`` postings, the cap may keep different
    members of an impact tie.  Those queries are held by a pair of
    uncapped servers instead, one on each warren.  Where the k-th result
    cuts a tie group of scores, the two sides may keep different members
    of it: each side's cut group must then lie within the single index's
    whole tie class at that score (read by an uncapped single-index server
    at K_TIES), with the same size and score.  Returns the counts."""
    from repro_torch.serve import RetrievalServer
    got_rows, want_rows = list(got_rows), list(want_rows)
    capped = [i for i, b in enumerate(cap_binds(single, queries, cap)) if b]
    if capped:
        servers = [RetrievalServer(w.clone(), k=k, max_postings=UNCAPPED,
                                   device=dev) for w in (sharded, single)]
        try:
            s_rows, w_rows = serve_both(servers,
                                        [queries[i] for i in capped])
        finally:
            for srv in servers:
                srv.close()
        for j, i in enumerate(capped):
            got_rows[i], want_rows[i] = s_rows[j], w_rows[j]
    g_txt = doc_texts(sharded, {a for r in got_rows for a, _ in r})
    s_txt = doc_texts(single, {a for r in want_rows for a, _ in r})
    cut = []
    for qi, (got, want) in enumerate(zip(got_rows, want_rows)):
        g, w = tie_groups(got, g_txt), tie_groups(want, s_txt)
        if g == w:
            continue
        check(len(g) == len(w) and g[:-1] == w[:-1]
              and g[-1][0] == w[-1][0] and len(g[-1][1]) == len(w[-1][1])
              and sum(len(t) for _, t in g) == k,
              f"sharded and single rows differ beyond a tie cut by k on "
              f"{queries[qi]!r}: {g} against {w}")
        cut.append(qi)
    if cut:
        wide = RetrievalServer(single.clone(), k=K_TIES,
                               max_postings=UNCAPPED, device=dev)
        try:
            wide_rows = serve_both((wide,), [queries[qi] for qi in cut])[0]
        finally:
            wide.close()
        w_txt = doc_texts(single, {a for r in wide_rows for a, _ in r})
        for qi, rows in zip(cut, wide_rows):
            groups = tie_groups(rows, w_txt)
            score, got = tie_groups(got_rows[qi], g_txt)[-1]
            _, want = tie_groups(want_rows[qi], s_txt)[-1]
            # the class is whole when the wide rows run past it
            check(len(rows) < K_TIES or groups[-1][0] != score,
                  f"the tie class of {queries[qi]!r} exceeds {K_TIES}")
            tied = dict(groups)[score]
            check(got <= tied and want <= tied,
                  f"a tie cut by k on {queries[qi]!r} holds a document "
                  f"outside the single index's tie class")
    return {"queries": len(queries), "equal": len(queries) - len(cut),
            "tie_cut_by_k": len(cut), "cap_binds": len(capped)}


def serve_both(servers, queries) -> list:
    """Submit every query to each server before collecting, so they share
    micro-batches; the rows of each server in query order."""
    handles = [[srv.batcher.submit(q) for q in queries] for srv in servers]
    return [[h.get(timeout=300) for h in hs] for hs in handles]


def sharded_step(step, card, host, sharded, single, queries, single_rows,
                 dev, **fields) -> None:
    """One step's queries on the card and on the host, bit for bit, and
    against the single index."""
    dev_rows, cpu_rows = serve_both((card, host), queries)
    same = sum(a == b for a, b in zip(dev_rows, cpu_rows))
    check(same == len(queries), f"after {step}: card and host sharded "
                                f"servers differ on {len(queries) - same} "
                                f"of {len(queries)} queries")
    vs = against_single(sharded, dev_rows, single, single_rows, queries,
                        dev)
    emit("sharded_step", step=step, card_vs_host_identical=same,
         vs_single=vs, **fields)


def single_index(dev, n_docs: int, queries):
    """A single ``Warren`` over the stream's first ``n_docs`` documents and
    its rows for ``queries`` from ``RetrievalServer`` on ``dev``: phase 8's
    yardstick, built over the same documents as the sharded index."""
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.serve import RetrievalServer
    single = Warren(DynamicIndex())
    t0 = time.perf_counter()
    ingest_documents(single, doc_generator(SEED, n_docs), batch=256)
    t_ingest = time.perf_counter() - t0
    server = RetrievalServer(single, k=10, device=dev)
    try:
        rows, _ = serve_closed_loop(server, queries, N_CLIENTS)
    finally:
        server.close()
    emit("sharded_single_index", docs=n_docs, ingest_s=t_ingest)
    return single, rows


def phase_sharded(dev, single, queries, single_rows, n_docs=N_DOCS,
                  step_queries=STEP_QUERIES, profile=True) -> dict:
    """A document-partitioned index of 4 shard groups × 2 replicas with
    quorum commit, every replica logging to its own WAL, served natively
    by ``RetrievalServer`` on the card; held against the same server on
    the host bit for bit and against a single index of the same documents
    by text."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core import ingest_documents
    from repro_torch.core.log import TransactionLog
    from repro_torch.data.synth import doc_generator
    from repro_torch.dist import elastic
    from repro_torch.dist.rebalance import Rebalancer
    from repro_torch.dist.shard_router import ShardedWarren
    from repro_torch.serve import RetrievalServer

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        os.makedirs(os.path.join(tmp, "wal"))
        sharded = ShardedWarren(
            n_shards=N_SHARDS, replicas=N_REPLICAS, async_scatter=True,
            log_dir=os.path.join(tmp, "wal"),
            static_dir=os.path.join(tmp, "static"))
        card = host = None
        try:
            t0 = time.perf_counter()
            ingest_documents(sharded, doc_generator(SEED, n_docs), batch=256)
            t_ingest = time.perf_counter() - t0
            counts = sharded.group_doc_counts()
            largest = int(np.argmax(counts))
            # the WAL of the largest group's replica 0, read back
            frames = list(TransactionLog(os.path.join(
                tmp, "wal", f"shard{largest:02d}r0.log")).replay())
            check(sum(f["t"] == "commit" for f in frames) > 0,
                  f"replica 0 of group {largest} logged no commit")
            emit("sharded_ingest", docs=n_docs, groups=N_SHARDS,
                 replicas=N_REPLICAS, seconds=t_ingest,
                 host_docs_per_s=n_docs / t_ingest, docs_per_group=counts,
                 wal_frames_largest_group_replica0=len(frames))
            out["ingest_s"] = t_ingest

            card = RetrievalServer(sharded, k=10, device=dev)
            # a clone: one warren object holds one read session at a time
            host = RetrievalServer(sharded.clone(), k=10, device="cpu")
            serve_closed_loop(card, queries[:16], N_CLIENTS)   # warm-up
            card.timings.reset()
            obs.registry().reset()
            t0 = time.perf_counter()
            dev_rows, lat = serve_closed_loop(card, queries, N_CLIENTS)
            wall = time.perf_counter() - t0
            summary = card.timing_summary()
            busy = (device_busy(lambda: serve_closed_loop(
                card, queries[:64], N_CLIENTS)) if profile else None)
            lat_ms = 1e3 * np.asarray(lat)
            serve = {"queries": len(queries), "clients": N_CLIENTS,
                     "wall_s": wall, "qps": len(queries) / wall,
                     "p50_ms": float(np.percentile(lat_ms, 50)),
                     "p95_ms": float(np.percentile(lat_ms, 95)),
                     "timing_summary": summary, "timings": {
                         k: v for k, v in card.timings.snapshot().items()
                         if k != "epoch"},
                     "traced_64_queries": busy}
            emit("sharded_serve", device=str(card.device), **serve)
            out["serve"] = serve
            cpu_rows = serve_both((host,), queries)[0]
            same = sum(a == b for a, b in zip(dev_rows, cpu_rows))
            check(same == len(queries),
                  f"card and host sharded servers differ on "
                  f"{len(queries) - same} of {len(queries)} queries")
            vs = against_single(sharded, dev_rows, single, single_rows,
                                queries, dev)
            emit("sharded_parity", card_vs_host_identical=same,
                 vs_single=vs)
            out["vs_single"] = vs

            def step_slice(i):
                lo = (i * step_queries) % len(queries)
                return (queries[lo:lo + step_queries],
                        single_rows[lo:lo + step_queries])

            reb = Rebalancer(sharded)
            new = elastic.split_shard_group(sharded, largest,
                                            rebalancer=reb)
            stats = reb.last_stats
            sharded_step("split", card, host, sharded, single,
                         *step_slice(0), dev, source=largest, new_group=new,
                         docs_per_group=sharded.group_doc_counts(),
                         swap_s=stats.swap_s, copy_s=stats.copy_s,
                         catchup_s=stats.catchup_s,
                         segments_streamed=stats.segments_streamed)
            out["swap_s"] = stats.swap_s
            elastic.merge_shard_groups(sharded, largest, new, rebalancer=reb)
            stats = reb.last_stats
            check(stats.kind.startswith("merge")
                  and sharded.groups[new].retired,
                  f"group {new} is not retired after the merge")
            sharded_step("merge", card, host, sharded, single,
                         *step_slice(4), dev, dest=largest, source=new,
                         docs_per_group=sharded.group_doc_counts(),
                         swap_s=stats.swap_s, copy_s=stats.copy_s,
                         catchup_s=stats.catchup_s,
                         segments_streamed=stats.segments_streamed)
            out["merge_swap_s"] = stats.swap_s

            cold = next(g for g in range(sharded.n_shards)
                        if g not in (largest, new))
            t0 = time.perf_counter()
            sharded.demote_group(cold)
            t_demote = time.perf_counter() - t0
            check(sharded.demoted()[cold] is not None,
                  f"group {cold} is not demoted")
            sharded_step("demote", card, host, sharded, single,
                         *step_slice(1), dev, group=cold,
                         demote_s=t_demote)

            for g in range(sharded.n_shards):
                sharded.mark_failed(g, 0)
            check(all(not h[0] for h in sharded.health()),
                  "a replica 0 is still marked live")
            sharded_step("failover", card, host, sharded, single,
                         *step_slice(2), dev, health=sharded.health())

            t0 = time.perf_counter()
            for g in range(sharded.n_shards):
                sharded.resurrect(g, 0)
            t_resurrect = time.perf_counter() - t0
            seqnums = sharded.group_seqnums()
            check(all(h == [True] * N_REPLICAS for h in sharded.health()),
                  "a replica is still failed after resurrect")
            check(all(len(set(s)) == 1 for s in seqnums),
                  f"replicas out of lockstep after resurrect: {seqnums}")
            sharded_step("resurrect", card, host, sharded, single,
                         *step_slice(3), dev, resurrect_s=t_resurrect,
                         group_seqnums=seqnums,
                         demoted=[d is not None for d in sharded.demoted()])
        finally:
            for srv in (card, host):
                if srv is not None:
                    srv.close()
            sharded.close()
    _sync(dev)
    return out


# --------------------------------------------------------------------- #
# phase autopilot: the control plane over a sharded warren (slice 11)
# --------------------------------------------------------------------- #
AP_SEED = 11
AP_TICKS = 400            # the day-in-the-life benchmark's full sizes
AP_FLATNESS = 1.5
AP_DOCS = 1_500           # its real pass; host ingest bounds it
AP_CORPUS_SEED = 7
AP_QUERIES = ["school education student", "government law state",
              "stock money business", "vibration conductor wind"]


def ap_sim_config(burn: bool = False):
    """The benchmark's simulated-day configuration (at most 8 groups); with
    ``burn`` the raw p95 and skew triggers are off and only a sustained
    SLO burn splits."""
    import math

    from repro_torch.dist.autopilot import (AutopilotConfig, ColdPolicy,
                                            Hysteresis, HotSplitPolicy)
    split = (HotSplitPolicy(p95_hot_ms=math.inf, skew_ratio=math.inf,
                            min_docs=64, sustain_ticks=3, max_groups=8,
                            burn_hot=1.0) if burn
             else HotSplitPolicy(p95_hot_ms=40.0, sustain_ticks=3,
                                 min_docs=64, max_groups=8))
    return AutopilotConfig(
        split=split,
        cold=ColdPolicy(demote_after_ticks=15, merge_after_ticks=40,
                        min_groups=2),
        hysteresis=Hysteresis(cooldown_ticks=4, min_dwell_ticks=1,
                              window_ticks=30, max_actions_per_window=6),
        pool=None)


def ap_sim_day(seed: int, ticks: int, controlled: bool = True,
               burn: bool = False):
    """One simulated day: a ``DriftingWorkload`` drives a ``SimCluster``
    for ``ticks`` ticks, the ``Controller`` closing the loop (or, with
    ``controlled`` false, the same signal drain and no policy; with
    ``burn`` the controller reads the cluster through an
    ``SLOSignalSource`` whose ``SLOMonitor`` runs on the sim clock).
    Returns (controller, cluster, worst-group p95 a tick, monitor)."""
    from repro_torch import obs
    from repro_torch.dist.autopilot import Controller
    from repro_torch.dist.simharness import (DriftingWorkload, SimClock,
                                             SimCluster)
    clock = SimClock()
    cluster = SimCluster(docs=1200, base_ms=2.0, ms_per_doc=0.05,
                         observe_latency=burn)
    wl = DriftingWorkload(seed=seed, topics=48, reads_per_tick=120,
                          writes_per_tick=8, phase_ticks=max(ticks // 3, 10))
    monitor = None
    signals = cluster
    if burn:
        monitor = obs.SLOMonitor(
            slos=[obs.SLO(name="serving_p95", kind="latency",
                          objective=0.95, metric="scatter_latency_ms",
                          threshold_ms=40.0)],
            windows=(("short", 5.0), ("long", 20.0)), clock=clock)
        signals = obs.SLOSignalSource(cluster, monitor)
    ctl = Controller(signals, cluster, config=ap_sim_config(burn=burn),
                     clock=clock)
    worst = []
    for _ in range(ticks):
        reads, writes = wl.tick_keys()
        cluster.route(reads)
        cluster.ingest(writes)
        if controlled:
            ctl.tick()
        else:
            cluster.collect()
        clock.advance()
        worst.append(max(cluster.base_ms + cluster.ms_per_doc * g.docs
                         for g in cluster.active()))
    return ctl, cluster, worst, monitor


def ap_simulated(seed: int = AP_SEED, ticks: int = AP_TICKS,
                 flatness: float = AP_FLATNESS) -> dict:
    """(a): the simulated day with the controller and with no policy, then
    the burn-driven day; the controller's worst-group p95 must stay within
    ``flatness`` of its start, the no-policy day must peak higher, and at
    least one split must be attributed to the burn."""
    from repro_torch import obs
    t0 = time.perf_counter()
    ctl, cluster, worst_ctl, _ = ap_sim_day(seed, ticks)
    _, _, worst_base, _ = ap_sim_day(seed, ticks, controlled=False)
    settle = max(ticks // 8, 5)          # the loop needs a few sustains
    start, peak_ctl = worst_ctl[0], max(worst_ctl[settle:])
    peak_base = max(worst_base)
    outcomes = {}
    for d in ctl.decisions:
        key = f"{d.kind}/{d.outcome}"
        outcomes[key] = outcomes.get(key, 0) + 1
    check(peak_ctl <= flatness * start,
          f"simulated day: the controller's worst-group p95 peaks at "
          f"{peak_ctl} ms, above {flatness} x its start {start} ms")
    check(peak_base > peak_ctl,
          f"simulated day: the no-policy day peaks at {peak_base} ms, not "
          f"above the controller's {peak_ctl} ms")
    sim_s = time.perf_counter() - t0
    # the burn day observes into scatter_latency_ms{group}: start clean
    obs.registry().reset()
    t0 = time.perf_counter()
    bctl, bcluster, _, monitor = ap_sim_day(seed, ticks, burn=True)
    burn_splits = [d for d in bctl.decisions if d.kind == "split"
                   and d.outcome == "applied" and "burn" in d.reason]
    check(len(burn_splits) > 0,
          "burn-driven day: no split was attributed to the SLO burn")
    rec = {"seed": seed, "ticks": ticks, "p95_start_ms": start,
           "p95_peak_controller_ms": peak_ctl,
           "p95_peak_baseline_ms": peak_base, "flatness_bound": flatness,
           "controller_over_start": peak_ctl / start,
           "baseline_over_start": peak_base / start,
           "decisions": outcomes, "groups_at_close": len(cluster.active()),
           "sim_s": sim_s, "burn_splits": len(burn_splits),
           "first_burn_split": burn_splits[0].to_record(),
           "closing_burn": monitor.burn("serving_p95"),
           "burn_groups_at_close": len(bcluster.active()),
           "burn_s": time.perf_counter() - t0}
    emit("autopilot_sim", **rec)
    return rec


def ap_real_config():
    """The benchmark's real-warren configuration: any windowed p95 is hot
    (splits capped at 3 groups), a dead replica resyncs after 2 ticks, an
    idle group demotes after 2."""
    from repro_torch.dist.autopilot import (AntiEntropyPolicy,
                                            AutopilotConfig, ColdPolicy,
                                            Hysteresis, HotSplitPolicy)
    return AutopilotConfig(
        split=HotSplitPolicy(p95_hot_ms=0.0, sustain_ticks=2, min_docs=1,
                             max_groups=3),
        cold=ColdPolicy(demote_after_ticks=2, merge_after_ticks=10 ** 6,
                        min_groups=1),
        anti_entropy=AntiEntropyPolicy(max_seq_lag=0, sustain_ticks=2),
        hysteresis=Hysteresis(cooldown_ticks=1, min_dwell_ticks=0,
                              window_ticks=50, max_actions_per_window=50),
        pool=None)


def http_get(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def ap_scrape(admin) -> dict:
    """``/metrics`` and ``/traces`` of ``admin``, with one ``autopilot.tick``
    trace's tree; what the phase checks of them."""
    text = http_get(admin.url("/metrics"))
    families = sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE ")})
    traces = json.loads(http_get(admin.url("/traces")))["traces"]
    ticks = [t for t in traces if t["root"] == "autopilot.tick"]
    check(bool(ticks), "/traces holds no autopilot.tick trace")
    tree = json.loads(http_get(admin.url(f"/traces/{ticks[-1]['trace_id']}")))
    return {"families": families, "traces": len(traces),
            "autopilot_tick_traces": len(ticks), "tick_trace": tree}


def ap_real(dev, n_docs: int, tmp: str, hierarchy: str) -> dict:
    """(b): a port ``ShardedWarren`` of 2 groups × 2 replicas served by
    ``RetrievalServer`` on ``dev`` (the native sharded path) under
    ``Controller.for_warren`` on a ``SimClock``: traffic heats the groups
    (split, capped at 3), replica 1 of group 0 fails (anti-entropy
    resyncs it), traffic stops (groups demote).  After every applied
    decision and at the end of each stage the card's top-10 equals the
    host server's bit for bit and a single index's by (score, text).  The
    ``LockWitness`` from ``hierarchy`` watches throughout, an
    ``AdminServer`` is scraped mid-split, and the decision log rotates
    through ``RotatingJsonl``."""
    from repro_torch import obs
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.dist.autopilot import Controller
    from repro_torch.dist.shard_router import ShardedWarren
    from repro_torch.dist.simharness import SimClock
    from repro_torch.serve import RetrievalServer

    witness = obs.install_witness(obs.LockWitness.from_hierarchy(hierarchy))
    warren = card = host = admin = None
    try:
        warren = ShardedWarren(n_shards=2, replicas=2,
                               static_dir=os.path.join(tmp, "static"))
        single = Warren(DynamicIndex())
        corpus = list(doc_generator(AP_CORPUS_SEED, n_docs, mean_len=30))
        t0 = time.perf_counter()
        ingest_documents(warren, corpus, batch=8)
        ingest_documents(single, corpus, batch=128)
        ingest_s = time.perf_counter() - t0
        card = RetrievalServer(warren, k=10, device=dev)
        host = RetrievalServer(warren.clone(), k=10, device="cpu")
        want = RetrievalServer(single, k=10, device=dev)
        try:
            single_rows = serve_both((want,), AP_QUERIES)[0]
        finally:
            want.close()
        obs.registry().reset()
        obs.tracer().reset()
        log = os.path.join(tmp, "decisions.jsonl")
        clock = SimClock()
        ctl = Controller.for_warren(warren, config=ap_real_config(),
                                    clock=clock, decision_log=log)
        admin = obs.AdminServer(host="127.0.0.1", warren=warren,
                                controller=ctl).start()
        scrapes = []

        def mid_split(w, stage, gid):
            if stage == "after_copy" and not scrapes:
                scrapes.append(ap_scrape(admin))

        warren.hooks["mid_migration"] = mid_split
        checks = []

        def parity(after: str) -> None:
            # the checks' reads stay out of the controller's signals
            obs.registry().disable()
            try:
                dev_rows, cpu_rows = serve_both((card, host), AP_QUERIES)
                same = sum(a == b for a, b in zip(dev_rows, cpu_rows))
                check(same == len(AP_QUERIES),
                      f"after {after}: card and host differ on "
                      f"{len(AP_QUERIES) - same} of {len(AP_QUERIES)} "
                      f"queries")
                vs = against_single(warren, dev_rows, single, single_rows,
                                    AP_QUERIES, dev)
            finally:
                obs.registry().enable()
            checks.append({"after": after, "card_vs_host_identical": same,
                           "vs_single": vs})

        def tick(serve: bool) -> None:
            if serve:
                serve_both((card,), AP_QUERIES)
            for d in ctl.tick():
                if d.outcome == "applied":
                    parity(f"tick {d.tick} {d.kind}")
            clock.advance()

        t0 = time.perf_counter()
        for _ in range(3):               # hot traffic: split, capped at 3
            tick(True)
        parity("hot traffic")
        warren.mark_failed(0, 1)         # replica loss: anti-entropy
        for _ in range(4):
            tick(True)
        parity("replica loss")
        for _ in range(4):               # traffic stops: demotion
            tick(False)
        parity("idle")
        loop_s = time.perf_counter() - t0

        applied = {d.kind for d in ctl.decisions if d.outcome == "applied"}
        check({"split", "resync", "demote"} <= applied,
              f"the controller applied {sorted(applied)}, not split, "
              f"resync and demote")
        check(warren.n_shards == 3, f"{warren.n_shards} groups after the "
                                    f"split, not 3")
        check(all(all(h) for h in warren.health()),
              f"a replica is not live at the end: {warren.health()}")
        check(bool(scrapes), "no admin scrape was taken mid-split")
        fams = scrapes[0]["families"]
        check("scatter_latency_ms" in fams
              and any(f.startswith("autopilot_") for f in fams),
              f"/metrics mid-split lacks scatter_latency_ms or the "
              f"autopilot_* families: {fams}")
        logged = [json.loads(line) for line in open(log)]
        check(logged == [d.to_record() for d in ctl.decisions],
              "the decision log differs from the controller's decisions")
        witness.check()
        edges = witness.edges()
        rec = {"docs": n_docs, "groups": warren.n_shards,
               "demoted": sum(d is not None for d in warren.demoted()),
               "health": warren.health(), "ingest_s": ingest_s,
               "loop_s": loop_s, "parity_checks": checks,
               "decisions": [d.to_record() for d in ctl.decisions],
               "decision_log_records": len(logged),
               "witness_edges": sorted(f"{a}->{b}" for a, b in edges),
               "witness_violations": 0,
               "scrape_mid_split": {k: v for k, v in scrapes[0].items()
                                    if k != "tick_trace"},
               "tick_trace_spans": [scrapes[0]["tick_trace"]["tree"]["name"]]
               + [c["name"] for c in scrapes[0]["tick_trace"]["tree"][
                   "children"]]}
    finally:
        obs.uninstall_witness()
        for srv in (card, host):
            if srv is not None:
                srv.close()
        if admin is not None:
            admin.close()
        if warren is not None:
            warren.close()
    emit("autopilot_decisions", decisions=[
        d["kind"] + " " + str(d["group"]) + "->" + str(d["target"]) + " "
        + d["outcome"] + " @ tick " + str(d["tick"])
        for d in rec["decisions"]])
    emit("autopilot_witness", edges=rec["witness_edges"], violations=0)
    emit("autopilot_real", **{k: v for k, v in rec.items()
                              if k not in ("witness_edges",)})
    return rec


def phase_autopilot(dev, n_docs: int = AP_DOCS, ticks: int = AP_TICKS,
                    seed: int = AP_SEED) -> dict:
    """Phase ``autopilot`` (see the module's docstring)."""
    import tempfile
    t0 = time.perf_counter()
    out = {"sim": ap_simulated(seed, ticks)}
    hierarchy = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "analysis", "lock_hierarchy.toml")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autopilot_") as tmp:
        out["real"] = ap_real(dev, n_docs, tmp, hierarchy)
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0
    card = nvidia_smi() if torch_device_type(dev) == "cuda" else "cpu"
    emit("autopilot", seconds=out["seconds"], card=card)
    return out


def phase_tiered(dev, n_docs=TIERED_DOCS, every=FREEZE_EVERY,
                 n_queries=TIERED_QUERIES) -> dict:
    """A TieredStore over the first ``n_docs`` documents of phase 2's
    stream, frozen after every ``every`` but the last, so the server reads
    on-disk runs plus a hot memtable; before and after one compaction its
    rows on the card must be a Warren's of the same documents, same
    addresses and same score bits."""
    import tempfile

    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.serve import RetrievalServer
    from repro_torch.tiered import TieredStore

    docs = list(doc_generator(SEED, n_docs))
    queries = make_queries(SEED + 2, n_queries)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiered_") as tmp:
        store = TieredStore(tmp)
        try:
            tiered, flat = store.warren(), Warren(DynamicIndex())
            t_ingest = t_freeze = 0.0
            for lo in range(0, n_docs, every):
                for w in (tiered, flat):
                    t0 = time.perf_counter()
                    ingest_documents(w, docs[lo:lo + every], batch=256)
                    if w is tiered:
                        t_ingest += time.perf_counter() - t0
                if lo + every < n_docs:
                    t0 = time.perf_counter()
                    store.freeze()
                    t_freeze += time.perf_counter() - t0
            hot = len(store.hot._segments)
            check(store.n_runs >= 4 and hot > 0,
                  f"{store.n_runs} runs and {hot} hot segments")
            runs = store.n_runs
            rounds = []
            for stage in ("runs", "compacted"):
                t_compact = None
                if stage == "compacted":
                    t0 = time.perf_counter()
                    store.compact_runs()
                    t_compact = time.perf_counter() - t0
                servers = (RetrievalServer(tiered, k=10, device=dev),
                           RetrievalServer(flat, k=10, device=dev))
                try:
                    t0 = time.perf_counter()
                    got, want = serve_both(servers, queries)
                    wall = time.perf_counter() - t0
                finally:
                    for srv in servers:
                        srv.close()
                same = sum(a == b for a, b in zip(got, want))
                check(same == n_queries,
                      f"{stage}: the tiered server differs from the Warren "
                      f"server on {n_queries - same} of {n_queries}")
                rounds.append({"stage": stage, "runs": store.n_runs,
                               "compact_s": t_compact, "identical": same,
                               "wall_s": wall,
                               "hits": sum(len(r) for r in got)})
            out = {"docs": n_docs, "runs_served": runs, "hot_segments": hot,
                   "ingest_s": t_ingest, "freeze_s": t_freeze,
                   "rounds": rounds}
            emit("tiered", **out)
        finally:
            store.close()
    _sync(dev)
    return out


# --------------------------------------------------------------------- #
# phase 10: gqa_decode against its plain version at small shapes
# --------------------------------------------------------------------- #
# (b, hkv, g, d, s, lengths or None for lengths drawn in [1, S]): the
# reference kernel test's sweep, then length 0, length = S, length > S, S
# off the 128 tile, G = 5 at D = 128, an odd D/8, and Qwen2.5-14B's
# per-layer shape at phase 11's cache; then, for the mma kernel's tile of
# 128 positions (16 a warp), lengths 127-129 and 63-65, a length that
# ends a split inside a tile (8 splits of 256), S below the tile,
# B·Hkv = 1024 (one split), D = 256 (the fma kernel in bfloat16 too),
# Hkv = 16 and Hkv = 3; last, Qwen2-MoE-A2.7B's per-layer shape at phase
# 12b's cache (Hkv = 16, G = 1, the mma kernel).
DECODE_CASES = [
    (2, 2, 4, 64, 256, None), (1, 4, 1, 128, 512, None),
    (2, 1, 8, 128, 300, None), (4, 2, 2, 64, 1024, None),
    (2, 2, 5, 16, 256, [0, 7]), (1, 2, 3, 32, 128, [0]),
    (2, 1, 5, 128, 256, [256, 256]), (2, 2, 5, 16, 300, [300, 1]),
    (2, 2, 5, 64, 300, [301, 10_000]), (1, 1, 1, 8, 1, [1]),
    (3, 2, 5, 24, 130, [129, 2, 130]), (8, 8, 5, 128, 1024, None),
    (3, 2, 5, 128, 256, [127, 128, 129]), (3, 2, 5, 64, 200, [63, 64, 65]),
    (1, 1, 5, 128, 2048, [700]),
    (2, 2, 5, 128, 40, [40, 17]), (128, 8, 5, 64, 256, None),
    (1, 2, 4, 256, 200, [200]), (1, 16, 2, 64, 96, [77]),
    (2, 3, 2, 32, 100, [100, 33]), (8, 16, 1, 128, 1024, None),
    # G above 8 (the mma kernel's 16-row instance, the fma kernel's groups
    # of 8 rows): Qwen3-MoE-235B's G = 16 at Hkv = 4, lengths off the tile,
    # length 0, length > S, several splits, and D > 128 at G = 16
    (2, 4, 16, 128, 300, [300, 129]), (2, 2, 9, 64, 256, [0, 200]),
    (2, 4, 12, 128, 256, [257, 10_000]), (3, 4, 16, 64, 1024, None),
    (4, 4, 16, 128, 4096, None), (2, 1, 12, 128, 700, [700, 333]),
    (2, 2, 9, 128, 130, [129, 0]), (2, 1, 16, 64, 40, [40, 17]),
    (1, 2, 16, 256, 200, [200]),
]
# the reference kernel test's tolerances: bfloat16 outputs round to 8 bits
DECODE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def decode_close(got, want, dtype: str) -> bool:
    """|got - want| <= tol + tol·|want| elementwise, the kernel tests'
    rtol = atol (bfloat16 outputs round to 8 bits at any magnitude)."""
    tol = DECODE_TOL[dtype]
    return bool(((got.float() - want.float()).abs()
                 <= tol + tol * want.float().abs()).all())


def phase_decode_small(dev) -> float:
    import torch
    from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
    from repro_torch.kernels.gqa_decode.kernel import path
    worst = {}
    for dtype in DECODE_TOL:
        tdt = getattr(torch, dtype)
        for b, hkv, g, d, s, lengths in DECODE_CASES:
            rng = np.random.default_rng(b * 100 + s + g)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(tdt)
                for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))
            if lengths is None:
                lengths = rng.integers(1, s + 1, size=b).tolist()
            length = torch.tensor(lengths, dtype=torch.int32)
            host = gqa_decode_ref(q, k, v, length)
            args = [x.to(dev) for x in (q, k, v, length)]
            got = gqa_decode(*args)
            want = gqa_decode_ref(*args)
            err = max(float((got.float() - want.float()).abs().max()),
                      float((got.float().cpu() - host.float()).abs().max()))
            case = f"{dtype} {[b, hkv, g, d, s]} length {lengths}"
            check(got.dtype == tdt and decode_close(got, want, dtype)
                  and decode_close(got.cpu(), host, dtype),
                  f"gqa_decode {case}: {err} from the plain version")
            check(all(not bool(got[i].any())
                      for i, n in enumerate(lengths) if n == 0),
                  f"gqa_decode {case}: length 0 must give zeros")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    _sync(dev)
    emit("decode_small", cases=[c[:5] for c in DECODE_CASES],
         paths={dtype: [path(getattr(torch, dtype), c[3])
                        for c in DECODE_CASES] for dtype in DECODE_TOL},
         max_abs_err=worst, tolerance={k: f"rtol = atol = {v}"
                                       for k, v in DECODE_TOL.items()},
         compared="kernel vs the plain version on the card and on the host")
    return max(worst.values())


# --------------------------------------------------------------------- #
# phase dist (a): gqa_decode at any G and D (fault (w))
# --------------------------------------------------------------------- #
# (b, hkv, g, d, s, lengths): G above one m16 tile (row tiles on the mma
# kernel's grid at D = 128 in bfloat16), D off a multiple of 8 (the fma
# kernel's element loads), D above 256 (two vectors of 8 a thread, four
# rows a launch) and above 512 (four vectors, one row a launch)
WIDE_CASES = [(2, 2, g, d, 1100, [1100, 517]) for g in (24, 40)
              for d in (36, 100, 128, 320)] + [
    (2, 2, 24, 640, 1100, [1100, 517]), (2, 2, 40, 1024, 1100, [1100, 517]),
    (1, 1, 40, 128, 4096, [4096]), (2, 1, 24, 36, 40, [0, 40]),
    (2, 3, 17, 128, 700, [10_000, 333])]


def phase_dist_gqa(dev) -> dict:
    """Fault (w): the kernel against its plain version on the card and the
    host at G in {24, 40} and D in {36, 100, 320} (and D = 128, the mma
    kernel's row tiles; D = 640 and 1024, the fma kernel's widest
    instance), float32 and bfloat16, each case timed against the
    plain version; the launches counted."""
    import torch
    from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
    from repro_torch.kernels.gqa_decode import kernel as gk
    cuda = torch.device(dev).type == "cuda"
    worst, rows = {}, []
    gk.launches = 0
    for dtype in DECODE_TOL:
        tdt = getattr(torch, dtype)
        for b, hkv, g, d, s, lengths in WIDE_CASES:
            rng = np.random.default_rng(b * 100 + s + g + d)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(tdt)
                for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))
            length = torch.tensor(lengths, dtype=torch.int32)
            host = gqa_decode_ref(q, k, v, length)
            args = [x.to(dev) for x in (q, k, v, length)]
            got = gqa_decode(*args)
            want = gqa_decode_ref(*args)
            err = max(float((got.float() - want.float()).abs().max()),
                      float((got.float().cpu() - host.float()).abs().max()))
            case = f"{dtype} {[b, hkv, g, d, s]} length {lengths}"
            check(got.dtype == tdt and decode_close(got, want, dtype)
                  and decode_close(got.cpu(), host, dtype),
                  f"gqa_decode {case}: {err} from the plain version")
            check(all(not bool(got[i].any())
                      for i, n in enumerate(lengths) if n == 0),
                  f"gqa_decode {case}: length 0 must give zeros")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            row = {"dtype": dtype, "shape": [b, hkv, g, d, s],
                   "path": gk.path(tdt, d), "max_abs_err": err}
            if cuda and s >= 1100:
                row["kernel_ms"] = time_cuda(lambda: gqa_decode(*args), n=20)
                row["plain_ms"] = time_cuda(lambda: gqa_decode_ref(*args),
                                            n=5)
            rows.append(row)
    _sync(dev)
    launches = gk.launches
    check(not cuda or launches >= 2 * len(WIDE_CASES),
          f"gqa_decode launched {launches} times for the wide cases")
    emit("dist_gqa", cases=rows, launches=launches, max_abs_err=worst,
         tolerance={k: f"rtol = atol = {v}" for k, v in DECODE_TOL.items()},
         compared="kernel vs the plain version on the card and on the host")
    return {"max_abs_err": max(worst.values()), "launches": launches,
            "cases": rows}


# --------------------------------------------------------------------- #
# phase dist (b)-(d): DTensor decode on one NCCL rank, the cross-pod
# reduce, the production dry run
# --------------------------------------------------------------------- #
DIST_ARCH = "internlm2-1.8b"
DIST_B = 4
DIST_PROMPT = 128          # 256 until phase autopilot (run time)
DIST_NEW = 32
# one cell a family, and Qwen2-MoE-A2.7B's train_4k: a cell of fault (x),
# which the card's DTensor could not trace until the MoE layer reduced its
# pending sums into the cuts they meet
DIST_CELLS = [("internlm2-1.8b", "train_4k"),
              ("qwen3-moe-235b-a22b", "decode_32k"),
              ("dlrm-rm2", "train_batch"), ("nequip", "minibatch_lg"),
              ("qwen2-moe-a2.7b", "train_4k")]


def greedy_steps(model, cache, prompts: np.ndarray, max_new: int,
                 feed=None):
    """LMServer.generate's greedy decode over ``prompts`` [B, P], one
    ``decode_step`` a token: P + max_new − 1 steps, max_new new tokens a
    sequence.  With ``feed`` (another run's fed tokens) those are fed
    instead.  Returns (fed tokens [steps, B], logits of every step, new
    tokens [B, max_new])."""
    import torch
    from repro_torch.models import transformer as T
    dev = model.rope_cos.device
    b, p = prompts.shape
    tokens = torch.as_tensor(prompts[:, 0], device=dev)
    fed, logits, new = [], [], []
    for i in range(p + max_new - 1):
        if feed is not None:
            tokens = feed[i]
        fed.append(tokens)
        out, _ = T.decode_step(model, cache, tokens)
        logits.append(shd_full(out))
        nxt = out.argmax(-1)
        nxt = shd_full(nxt)
        if i >= p - 1:
            new.append(nxt)
        tokens = (torch.as_tensor(prompts[:, i + 1], device=dev)
                  if i + 1 < p else nxt)
    return fed, logits, torch.stack(new, 1)


def shd_full(x):
    """A DTensor's whole value; any other tensor as it is."""
    from repro_torch.dist.on_mesh import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def dist_decode(dev, mesh, cfg, b: int = DIST_B, prompt: int = DIST_PROMPT,
                max_new: int = DIST_NEW) -> dict:
    """(b): the same greedy decode on plain tensors, then with the model
    and cache as DTensors on ``mesh`` (fed the plain run's tokens), every
    step's logits bit for bit, the new tokens equal."""
    import torch
    from repro_torch.dist import elastic, sharding as shd
    from repro_torch.dist.on_mesh import replicated_implicitly
    from repro_torch.kernels.gqa_decode import kernel as gk
    from repro_torch.models import transformer as T
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 26)
    model = T.init_params(cfg, g, dev)
    prompts = np.random.default_rng(SEED + 26).integers(
        0, cfg.vocab, size=(b, prompt))
    s = prompt + max_new
    t0 = time.perf_counter()
    fed, want, want_new = greedy_steps(model, T.init_cache(cfg, b, s, dev),
                                       prompts, max_new)
    _sync(dev)
    plain_s = time.perf_counter() - t0
    steps = len(fed)
    places = shd.lm_param_sharding(mesh, model)
    shd.distribute_module(model, mesh, places)
    cache = elastic.reshard(T.init_cache(cfg, b, s, dev),
                            shd.lm_cache_sharding(mesh, b), mesh)
    gk.launches = 0
    t0 = time.perf_counter()
    with replicated_implicitly():
        _, got, got_new = greedy_steps(model, cache, prompts, max_new,
                                       feed=fed)
    _sync(dev)
    dtensor_s = time.perf_counter() - t0
    launches = gk.launches
    cuda = torch.device(dev).type == "cuda"
    check(not cuda or launches == cfg.n_layers * steps,
          f"gqa_decode launched {launches} times for {steps} DTensor steps "
          f"of {cfg.n_layers} layers")
    same = sum(bool(torch.equal(a, w)) for a, w in zip(got, want))
    check(same == steps, f"DTensor logits differ from the plain decode's "
                         f"on {steps - same} of {steps} steps")
    check(bool(torch.equal(got_new, want_new)),
          "DTensor decode's tokens differ from the plain decode's")
    rec = {"arch": cfg.name, "batch": b, "prompt": prompt, "new": max_new,
           "steps": steps, "launches": launches,
           "logits_bit_equal_steps": same, "tokens_equal": True,
           "plain_ms_a_step": 1e3 * plain_s / steps,
           "dtensor_ms_a_step": 1e3 * dtensor_s / steps,
           "param_placements": sorted({str(v) for v in places.values()}),
           "cache_placements": {k: str(v) for k, v in
                                shd.lm_cache_sharding(mesh, b).items()}}
    del model, cache, want, got
    emit("dist_decode", **rec)
    return rec


def dist_cross_pod(dev, cfg) -> dict:
    """(c): the compressed reduce over a one-rank ("pod",) mesh on real
    all-reduces, held to the single-process path bit for bit."""
    import torch
    from repro_torch.dist import compression as C
    from repro_torch.launch.mesh import make_mesh_from_sizes
    from repro_torch.models import transformer as T
    mesh = make_mesh_from_sizes({"pod": 1}, device_type=dev.type)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 27)
    grads = {name: torch.randn(shape, generator=g, device=dev) * 1e-3
             for name, shape in T.layer_shapes(cfg).items()}
    res = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-6
           for k, v in grads.items()}
    t0 = time.perf_counter()
    out, new_res = C.cross_pod_reduce_compressed(grads, res, mesh)
    _sync(dev)
    reduce_s = time.perf_counter() - t0
    q, sc, want_res = C.compress_with_feedback(grads, res)
    want = C.decompress(q, sc)
    bad = [k for k in grads if not (torch.equal(out[k], want[k])
                                    and torch.equal(new_res[k],
                                                    want_res[k]))]
    check(not bad, f"cross_pod_reduce_compressed differs from "
                   f"decompress(compress_with_feedback) on {bad}")
    values = sum(v.numel() for v in grads.values())
    rec = {"leaves": len(grads), "values": values,
           "payload_bytes": -(-values // 2) * 4, "reduce_ms": 1e3 * reduce_s,
           "bit_equal": True}
    emit("dist_cross_pod", **rec)
    return rec


def dist_dryrun_start(dev, cells=DIST_CELLS):
    """(d), started: the production dry run on the 16×16 mesh of ``dev``'s
    fakes in a subprocess (its fakes hold no card memory; it runs beside
    the other phases on another host core).  Returns what
    :func:`dist_dryrun_collect` waits for."""
    import tempfile
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dry_")
    path = os.path.join(tmp.name, "dry.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--production", "--device", torch_device_type(dev), "--out", path]
    for arch, shape in cells:
        cmd += ["--cell", f"{arch}:{shape}"]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=src),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(_kill, proc)     # a phase before (d) may fail
    return proc, tmp, path, cells, time.perf_counter()


def _kill(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def dist_dryrun_collect(started, timeout: float = 600) -> dict:
    """(d), finished: each cell's record (all must be ``ok``)."""
    proc, tmp, path, cells, t0 = started
    with tmp:
        try:
            _, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(path)] \
            if os.path.exists(path) else []
    check(len(recs) == len(cells), f"the dry run wrote {len(recs)} of "
                                   f"{len(cells)} records: {err[-2000:]}")
    out = {}
    for rec in recs:
        check(rec["ok"], f"dry run {rec['arch']} {rec['shape']} on "
                         f"{rec['mesh']}: {rec.get('error')}")
        out[f"{rec['arch']}:{rec['shape']}"] = {
            k: rec[k] for k in ("mesh", "n_devices", "device", "fits",
                                "collectives", "trace_s", "total_s")} | {
            "peak_bytes": rec["memory"]["peak_bytes"],
            "argument_bytes": rec["memory"]["argument_bytes"],
            "flops": rec["cost"]["flops"]}
    emit("dist_dryrun", seconds=seconds, cells=out)
    return out


def torch_device_type(dev) -> str:
    import torch
    return torch.device(dev).type


def phase_dist(dev, cfg=None, prompt: int = DIST_PROMPT,
               max_new: int = DIST_NEW, cells=DIST_CELLS, dry=None) -> dict:
    """Phase 25, ``dist`` (see the module's docstring).  ``dry`` is (d)'s
    subprocess where the caller started it earlier, else it starts here."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as M
    cfg = cfg or get_arch(DIST_ARCH).config
    if dry is None:
        dry = dist_dryrun_start(dev, cells)
    try:
        out = {"gqa": phase_dist_gqa(dev)}
        backend = "nccl" if torch_device_type(dev) == "cuda" else "gloo"
        with M.file_process_group(backend):
            mesh = M.make_local_mesh(device_type=torch_device_type(dev))
            out["decode"] = dist_decode(dev, mesh, cfg, prompt=prompt,
                                        max_new=max_new)
            out["cross_pod"] = dist_cross_pod(dev, cfg)
    finally:
        out_dry = dist_dryrun_collect(dry)
    out["dryrun"] = out_dry
    return out


# --------------------------------------------------------------------- #
# phase 11: LM decode serving, the third slice's main path
# --------------------------------------------------------------------- #
LM_ARCH = "qwen2.5-14b"
LM_SLOTS = 8
LM_MAX_LEN = 1024
# a prompt of 16-64 tokens (a question and a short retrieved passage).  A
# RAG prompt of a few passages took up to 512 tokens before phase 12b
# came, 256 until phase dist came, cut to keep the whole run under 600 s
# (at 512 phase 11 took 104 s of a 629 s run on an H100, PERF.md §4).
# At 8 slots of 8 KV heads gqa_decode cuts the 1,024 positions into two
# splits of 512, so no length here or before put data in the second one:
# the served decode runs split 0 alone (kv_splits in the phase's row);
# phase moe_serve_qwen3 and phase 12 hold data in several
LM_PROMPT_LENS = (16, 64)
LM_MAX_NEW = 32
# The bf16 decode's logits against the float32 forward on the same weights
# and tokens, measured against what bf16 rounding alone does there: the
# port's forward in bf16 (another order of operations, no kernel) against
# the same float32 forward.  The decode may be at most LOGIT_RATIO times
# as far in mean |Δ|, and lose at most TOP1_SLACK of top-1 agreement.
LOGIT_RATIO = 1.5
TOP1_SLACK = 0.1
# The reference's init draws every layer weight N(0, 1/n_layers) (ROADMAP
# fault (h)): there bf16 rounding everywhere hides a small error in the
# decode's attention.  So phase 11 also serves a model whose weights are
# drawn anew, only here, at a well-conditioned init (each matrix
# N(0, 1/d_in), d_in its first axis; the embedding N(0, 1); norms 1, biases
# 0), at full width and COND_LAYERS layers, and holds its decode's logits
# against the same decode on the same tokens with attention by the plain
# version (float32, rounded once): every other operation is the same
# launch on the same shapes, so only the kernel's arithmetic differs.  The
# mean |Δ| may be at most COND_RATIO times the bf16 forward's own distance
# from the float32 forward.  Neither forward can be the reference: a
# decode with P rounded once to bf16 in P·V is as far from the float32
# forward as the bf16 forward is (tests/test_torch_lmserver.py), and on an
# H100 the decode's GEMVs and the forward's GEMMs round apart as far as a
# wrong P does.  More layers blur the line: rounding differences grow
# through each layer (PERF.md), so the model is cut to one.
COND_LAYERS = 1
COND_RATIO = 0.5


def rag_prompts(vocab: int, n: int, lens=LM_PROMPT_LENS, seed: int = SEED):
    rng = np.random.default_rng(seed + 13)
    sizes = rng.integers(lens[0], lens[1] + 1, size=n)
    return [rng.integers(0, vocab, size=int(m)).tolist() for m in sizes]


@contextlib.contextmanager
def recorded_steps(server):
    """Record every step's fed tokens and logits of ``server.generate``."""
    steps = []
    step = server.step

    def recording(tokens):
        logits = step(tokens)
        steps.append((tokens.clone(), logits))
        return logits
    server.step = recording
    try:
        yield steps
    finally:
        del server.step     # back to the method, with no cycle to the server


def fp8_round_(model) -> None:
    """Round every weight in place to float8 e4m3 with a per-tensor scale
    (amax → 448), kept in the model's dtype: the same decode, in a lower
    precision than bfloat16."""
    import torch
    with torch.no_grad():
        for p in model.parameters():
            scale = p.float().abs().amax().clamp(min=1e-12) / 448.0
            p.copy_((p.float() / scale).to(torch.float8_e4m3fn).float()
                    * scale)


def condition_(model, generator) -> None:
    """Redraw every weight matrix of ``model`` in place from
    ``generator``: N(0, 1/d_in) with d_in its first axis ([in, out]
    layouts; an MoE router and shared-expert gate too), each expert's
    N(0, 1/d_in) with d_in the middle axis ([E, in, out]), the embedding
    N(0, 1); norms and biases stay as drawn."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                scale = 1.0 if name == "embed" else 1.0 / np.sqrt(p.shape[0])
            elif p.dim() == 3:
                scale = 1.0 / np.sqrt(p.shape[1])
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * scale)


def served_logits(server, prompts, max_new: int):
    """(fed tokens [B, T], logits [B, T, V]) of every step of one
    ``server.generate`` call."""
    import torch
    with recorded_steps(server) as steps:
        server.generate(prompts, max_new=max_new)
    return (torch.stack([t for t, _ in steps], 1),
            torch.stack([lg for _, lg in steps], 1))


def single_bf16_p_attention(q, k, v, length):
    """gqa_decode's plain version with P rounded once to bfloat16 in P·V
    (its normaliser from the float32 P): the wrong P that the mma
    kernel's hi + lo split avoids, and that the conditioned check must
    refuse."""
    import torch
    d, s = q.shape[-1], k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, None, :] < length[:, None, None, None]
    scores = torch.where(valid, scores, -1e30)
    p = torch.where(valid, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p.bfloat16().float(), v.float())
    return (acc / p.sum(-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


@contextlib.contextmanager
def plain_attention(attention=None):
    """``decode_step`` with attention by ``attention`` (by default
    gqa_decode's plain version)."""
    from repro_torch.kernels.gqa_decode import gqa_decode_ref
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    kernel_fn = gqa_kernel.gqa_decode
    gqa_kernel.gqa_decode = attention or gqa_decode_ref
    try:
        yield
    finally:
        gqa_kernel.gqa_decode = kernel_fn


def replay(model, fed, slots: int, max_len: int, dtype=None):
    """``decode_step``'s logits [B, T, V] on the tokens ``fed`` [B, T],
    every weight widened to ``dtype`` where one is given (and the cache
    kept in it)."""
    import torch
    from repro_torch.models.transformer import decode_step, init_cache
    cache = init_cache(model.cfg, slots, max_len, model.device, dtype)
    return torch.stack([decode_step(model, cache, fed[:, i], dtype)[0]
                        for i in range(fed.shape[1])], 1)


def served_splits(dev, cfg, slots: int, max_len: int, steps: int,
                  sms: int = None):
    """The served cache's KV splits in ``gqa_decode`` (``splits`` runs of
    ``chunk`` positions) and how many of them hold data at the last step
    (``holding_data``): every slot steps together, so each then holds
    ``steps`` positions.  The split rule counts the card's SMs (``sms``,
    read from ``dev`` where not given); None on the host."""
    import torch
    from repro_torch.device import sm_count
    from repro_torch.kernels.gqa_decode import kernel as gk
    if sms is None:
        if torch.device(dev).type != "cuda":
            return None
        sms = sm_count(torch.device(dev))
    kind = gk.path(cfg.torch_dtype, cfg.head_dim)
    blocks = slots * cfg.n_kv_heads * (gk.row_tiles(cfg.group_size)
                                       if kind == gk.MMA else 1)
    n, chunk = gk.splits(blocks, max_len, sms, kind)
    return {"splits": n, "chunk": chunk,
            "holding_data": min(n, -(-min(steps, max_len) // chunk))}


def conditioned_check(dev, cfg, prompts, slots: int, max_len: int,
                      max_new: int, layers: int = COND_LAYERS) -> dict:
    """The decode at a well-conditioned init against the same decode with
    the plain attention (see COND_RATIO); the decode with P rounded once
    to bfloat16 and an fp8-weight decode must fail it."""
    import torch
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve import LMServer
    cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    model = init_params(cfg, gen, dev)
    condition_(model, gen)
    server = LMServer(model, max_slots=slots, max_len=max_len, device=dev)
    fed, dec = served_logits(server, prompts, max_new)
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits at "
                                           "the conditioned init")
    with plain_attention():
        ref = replay(model, fed, slots, max_len)
    rounding = logit_agreement(forward(model, fed),
                               forward(model, fed, dtype=torch.float32))
    got = logit_agreement(dec, ref)
    del dec
    with plain_attention(single_bf16_p_attention):
        wrong = logit_agreement(replay(model, fed, slots, max_len), ref)
    fp8_round_(model)
    fp8 = logit_agreement(replay(model, fed, slots, max_len), ref)
    del ref, model, server
    tol = COND_RATIO * rounding["mean_abs"]
    row = dict(arch=cfg.name, layers=layers,
               init="N(0, 1/d_in) a matrix (an expert's d_in its middle "
                    "axis), embedding N(0, 1)",
               decode_vs_plain_attention=got, forward_vs_f32=rounding,
               single_bf16_p_vs_plain_attention=wrong,
               fp8_weights_vs_plain_attention=fp8, mean_abs_tol=tol,
               ratio=got["mean_abs"] / rounding["mean_abs"],
               single_bf16_p_ratio=wrong["mean_abs"] / rounding["mean_abs"],
               fp8_ratio=fp8["mean_abs"] / rounding["mean_abs"],
               tolerance=f"decode mean |Δ| from the same decode with the "
                         f"plain attention <= {COND_RATIO} x the bf16 "
                         f"forward's from float32")
    emit("lm_serve_conditioned", **row)
    check(got["mean_abs"] <= tol, f"conditioned decode logits vs the plain "
                                  f"attention's: {row}")
    check(wrong["mean_abs"] > tol, f"the conditioned tolerance passes a "
                                   f"decode with P rounded once to "
                                   f"bfloat16: {row}")
    check(fp8["mean_abs"] > tol, f"the conditioned tolerance passes an "
                                 f"fp8-weight decode: {row}")
    return row


def logit_agreement(dec, ref) -> dict:
    """max and mean |Δ| of two [B, T, V] logit tensors, and the share of
    (sequence, step) whose argmax agrees."""
    import torch
    diff_max, diff_sum, agree = 0.0, 0.0, 0
    for i in range(dec.shape[0]):           # one sequence at a time
        d = (dec[i].float() - ref[i].float()).abs()
        diff_max = max(diff_max, float(d.max()))
        diff_sum += float(d.sum(dtype=torch.float64))
        agree += int((dec[i].argmax(-1) == ref[i].argmax(-1)).sum())
    n = dec.shape[0] * dec.shape[1]
    return {"max_abs": diff_max, "mean_abs": diff_sum / (n * dec.shape[2]),
            "top1_agree": agree / n}


def phase_lm_serve(dev, cfg=None, slots: int = LM_SLOTS,
                   max_len: int = LM_MAX_LEN, lens=LM_PROMPT_LENS,
                   max_new: int = LM_MAX_NEW,
                   cond_layers: int = COND_LAYERS) -> dict:
    import torch
    from repro_torch.configs.lm_family import get_config
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve import LMServer
    cfg = cfg or get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = init_params(cfg, gen, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = rag_prompts(cfg.vocab, slots, lens)
    server = LMServer(model, max_slots=slots, max_len=max_len, device=dev)
    runs = []
    for call in range(2):
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with recorded_steps(server) as steps:
            _sync(dev)
            gqa_kernel.launches = 0                 # the slice's main path
            t0 = time.perf_counter()
            outs = server.generate(prompts, max_new=max_new)
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = gqa_kernel.launches          # ends here
        n_steps = len(steps)
        check(n_steps == max(map(len, prompts)) + max_new,
              f"call {call}: {n_steps} decode steps")
        check(launches == _expected_launches(dev, cfg.n_layers * n_steps),
              f"call {call}: gqa_decode launched {launches} times in "
              f"{n_steps} steps of {cfg.n_layers} layers")
        check(all(len(o) == max_new for o in outs)
              and all(0 <= t < cfg.vocab for o in outs for t in o),
              f"call {call}: malformed output")
        runs.append(dict(
            seconds=seconds, steps=n_steps, launches=launches,
            ms_per_step=1e3 * seconds / n_steps,
            new_tokens_per_s=slots * max_new / seconds,
            tokens_per_s=slots * n_steps / seconds,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if torch.device(dev).type == "cuda" else None)))
        if call == 0:
            first, fed = outs, torch.stack([t for t, _ in steps], 1)
            dec = torch.stack([lg for _, lg in steps], 1)   # [B, T, V]
        del steps
    check(outs == first, "two generate calls gave different tokens")
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
    server.cache = None

    # the float32 reference: the port's forward on the tokens the decode
    # was fed, every weight widened from bfloat16 one layer at a time
    t0 = time.perf_counter()
    ref = forward(model, fed, dtype=torch.float32)
    _sync(dev)
    ref_s = time.perf_counter() - t0
    bf16 = logit_agreement(dec, ref)
    del dec
    rounding = logit_agreement(forward(model, fed), ref)
    logit_tol = LOGIT_RATIO * rounding["mean_abs"]
    top1_min = rounding["top1_agree"] - TOP1_SLACK

    # the same decode in a lower precision must fall outside the tolerance
    fp8_round_(model)
    low = replay(model, fed, slots, max_len)
    fp8 = logit_agreement(low, ref)
    del low, ref, model, server
    gc.collect()
    cond = conditioned_check(dev, cfg, prompts, slots, max_len, max_new,
                             cond_layers)
    gc.collect()                # phase 12 needs the card's memory back
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    row = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
               params=cfg.param_count(), slots=slots, max_len=max_len,
               prompt_lens=[len(p) for p in prompts], max_new=max_new,
               init_s=init_s, calls=runs,
               kv_splits=served_splits(dev, cfg, slots, max_len,
                                       runs[0]["steps"]),
               tokens_equal=True, ref_forward_s=ref_s, logits_vs_f32=bf16,
               forward_vs_f32=rounding, fp8_weights_vs_f32=fp8,
               mean_abs_tol=logit_tol, top1_min=top1_min,
               tolerance=f"decode mean |Δ| <= {LOGIT_RATIO} x the "
                         f"{cfg.dtype} forward's, top-1 agreement >= its "
                         f"- {TOP1_SLACK}", conditioned=cond)
    emit("lm_serve", **row)
    check(bf16["mean_abs"] <= logit_tol and bf16["top1_agree"] >= top1_min,
          f"decode logits vs the float32 reference: {bf16}, "
          f"tolerance {logit_tol}, top-1 >= {top1_min}")
    check(fp8["mean_abs"] > logit_tol or fp8["top1_agree"] < top1_min,
          f"the tolerance passes an fp8-weight decode: {fp8}")
    return row


# --------------------------------------------------------------------- #
# phase 12: decode at the deployment width, 4 sequences at 32k
# --------------------------------------------------------------------- #
DEPLOY_B = 4
DEPLOY_S = 32_768
DEPLOY_LENS = (28_672, 32_767)
DEPLOY_STEPS = 20


def decode_bound(n_kv_rows: int, hkv: int, g: int, d: int, b: int,
                 elt: int, bw: float, flops: float):
    """(bound_ms, bound_by, bytes) of gqa_decode: every valid K and V row
    read once, q read and the output written once, over the memory rate;
    or its 4·rows·Hkv·G·D float32 operations over the float32 rate."""
    nbytes = 2 * n_kv_rows * hkv * d * elt + 2 * b * hkv * g * d * elt
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * 4 * n_kv_rows * hkv * g * d / flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


# At deployment lengths an output row averages 10^4-10^6 rows of V and is
# small (rms ~1e-2 at 32k, ~2e-3 at 500k on seeded K/V), so phase 10's
# absolute 2e-2 would pass zeros.  This tolerance scales with the output:
# 1e-2 relative is above the one bfloat16 ulp (2^-7 relative) by which two
# roundings of nearly equal float32 sums can differ; the floor, 1e-3 of the
# output's rms, is for entries near 0.
DEPLOY_RTOL, DEPLOY_FLOOR = 1e-2, 1e-3


def deploy_close(got, want) -> bool:
    """|got - want| <= DEPLOY_RTOL·|want| + DEPLOY_FLOOR·rms(want)."""
    got, want = got.float(), want.float()
    rms = float(want.pow(2).mean().sqrt())
    return bool(((got - want).abs()
                 <= DEPLOY_RTOL * want.abs() + DEPLOY_FLOOR * rms).all())


def check_deploy(name, q, k, v, length) -> float:
    """The kernel against its plain version at a deployment shape; the
    tolerance must also refuse an answer that reads half the positions,
    and zeros.  Returns max |Δ|."""
    import torch
    from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
    got = gqa_decode(q, k, v, length)
    want = gqa_decode_ref(q, k, v, length)
    err = float((got.float() - want.float()).abs().max())
    check(deploy_close(got, want),
          f"{name}: gqa_decode is {err} from the plain version")
    check(not deploy_close(gqa_decode_ref(q, k, v, length // 2), want)
          and not deploy_close(torch.zeros_like(want), want),
          f"{name}: the tolerance passes half the positions, or zeros")
    return err


def time_decode_kernel(name, q, k, v, length, bw, flops, flush) -> dict:
    """gqa_decode against its plain version and the library's attention at
    one shape; every row of ``length`` is S, as the library call takes no
    lengths."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from repro_torch.kernels.gqa_decode import gqa_decode, gqa_decode_ref
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    b, hkv, g, d = q.shape
    err = check_deploy(name, q, k, v, length)
    fma = gqa_kernel._launch(q, k, v, length, gqa_kernel.FMA)
    check(deploy_close(fma, gqa_decode_ref(q, k, v, length)),
          f"{name}: the fma kernel disagrees with the plain version")
    plain_ms = time_cuda(lambda: gqa_decode_ref(q, k, v, length), n=5,
                         flush=flush.zero_)
    qs, kt, vt = q.reshape(b, hkv * g, 1, d), k.transpose(1, 2), \
        v.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, enable_gqa=True)
    lib = library()
    lib_err = float((lib.reshape(q.shape).float()
                     - gqa_decode(q, k, v, length).float()).abs().max())
    # the kernel, the fma kernel and the library call in turns (A B C C B
    # A), TIMED_LAUNCHES // 2 launches each time; each time is the mean of
    # its two medians
    calls = {"kernel": lambda: gqa_decode(q, k, v, length),
             "fma": lambda: gqa_kernel._launch(q, k, v, length,
                                               gqa_kernel.FMA),
             "library": library}
    ms, turns = time_in_turns(calls, flush=flush.zero_)
    kernel_ms, fma_ms, library_ms = (ms[key] for key in calls)
    # the kernel's two passes alone, device time (the profiler sees them)
    passes = {name: kernel_device_ms(calls["kernel"], f"gqa_{name}_kernel")
              for name in (f"{gqa_kernel.path(q.dtype, d)}_partial",
                           "combine")}
    # the dispatcher's own choice: on an H100 the profiler records no
    # device activity for this call
    library_backend = SDPBackend(torch._fused_sdp_choice(
        qs, kt, vt, None, 0.0, False, scale=None, enable_gqa=True)).name
    rows = int(length.clamp(max=k.shape[1]).sum())
    bound_ms, bound_by, nbytes = decode_bound(rows, hkv, g, d, b,
                                              q.element_size(), bw, flops)
    return dict(shape=[b, k.shape[1], hkv, d], g=g, max_abs_err=err,
                path=gqa_kernel.path(q.dtype, d), kernel_ms=kernel_ms,
                plain_ms=plain_ms, fma_ms=fma_ms,
                library_ms=library_ms, turns_ms=turns,
                device_ms=passes,
                library_max_abs_diff=lib_err,
                kernel_over_library=kernel_ms / library_ms,
                fma_over_library=fma_ms / library_ms,
                library_call="F.scaled_dot_product_attention(enable_gqa="
                             "True), equal lengths",
                library_backend=library_backend,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                share_of_bound=bound_ms / kernel_ms,
                tolerance=f"|d| <= {DEPLOY_RTOL} |want| + {DEPLOY_FLOOR} "
                          f"rms(want); refuses half the positions and zeros")


def phase_decode_deploy(dev, bw, flops, cfg=None, b: int = DEPLOY_B,
                        s: int = DEPLOY_S, lens=DEPLOY_LENS,
                        steps: int = DEPLOY_STEPS, s_long=None) -> dict:
    import torch
    from repro_torch.configs.lm_family import SHAPES, get_config
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params)
    cfg = cfg or get_config(LM_ARCH)
    s_long = s_long or SHAPES["long_500k"]["seq"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = init_params(cfg, gen, dev)
    cache = init_cache(cfg, b, s, dev)
    for key in ("k", "v"):
        for layer in cache[key]:
            layer.normal_(generator=gen)
    rng = np.random.default_rng(SEED + 17)
    lengths = rng.integers(lens[0], lens[1] + 1, size=b)
    cache["length"].copy_(torch.from_numpy(lengths.astype(np.int32)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(
        steps + 2, b))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters()) \
        - model.embed.numel() * model.embed.element_size()
    hkv, g, d = cfg.n_kv_heads, cfg.group_size, cfg.head_dim
    dt = cfg.torch_dtype
    elt = cache["k"].element_size()

    for i in range(2):                       # warm-up
        decode_step(model, cache, tokens[i])
    torch.cuda.synchronize()
    kv_rows, ms = 0, []
    gqa_kernel.launches = 0
    for i in range(2, steps + 2):
        kv_rows += int(torch.clamp(cache["length"] + 1, max=s).sum())
        t0 = time.perf_counter()
        logits, _ = decode_step(model, cache, tokens[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = gqa_kernel.launches
    check(launches == _expected_launches(dev, cfg.n_layers * steps),
          f"gqa_decode launched {launches} times in {steps} steps")
    check(bool(torch.isfinite(logits).all()), "non-finite logits at 32k")
    kv_bytes = 2 * cfg.n_layers * (kv_rows / steps) * hkv * d * elt
    step_bound_ms = 1e3 * (weight_bytes + kv_bytes) / bw
    busy = device_busy(lambda: [decode_step(model, cache, tokens[i])
                                for i in range(3)])
    step = dict(shape=[b, s], lengths=lengths.tolist(),
                setup_s=setup_s, steps=steps,
                ms_per_step_median=float(np.median(ms)),
                ms_per_step_mean=float(np.mean(ms)),
                step_bound_ms=step_bound_ms, weight_gb=weight_bytes / 1e9,
                kv_gb=kv_bytes / 1e9, launches=launches,
                profiled_3_steps=busy,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("decode_deploy_step", **step)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev,
                    dtype=torch.float32).to(dt)
    # layer 0 drawn anew from the seed: the steps wrote model rows of
    # scores far above the seeded ones, which would decide the output alone
    k0, v0 = cache["k"][0].normal_(generator=gen), \
        cache["v"][0].normal_(generator=gen)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    rows = {"32k": time_decode_kernel("32k", q, k0, v0, full, bw, flops,
                                      flush)}
    cached = cache["length"].clone()        # the seeded lengths, stepped
    rows["32k"]["cache_lengths"] = dict(
        lengths=cached.tolist(),
        max_abs_err=check_deploy("32k at the cache's lengths", q, k0, v0,
                                 cached),
        kernel_ms=time_cuda(lambda: gqa_decode(q, k0, v0, cached),
                            flush=flush.zero_),
        bound_ms=decode_bound(int(torch.clamp(cached, max=s).sum()),
                              hkv, g, d, b, elt, bw, flops)[0])
    emit("decode_deploy_kernel", case="32k", **rows["32k"])
    del cache, model, k0, v0, q
    gc.collect()
    torch.cuda.empty_cache()
    kv = [torch.empty((1, s_long, hkv, d), dtype=dt, device=dev)
          .normal_(generator=gen) for _ in range(2)]
    q = torch.randn((1, hkv, g, d), generator=gen, device=dev,
                    dtype=torch.float32).to(dt)
    full = torch.full((1,), s_long, dtype=torch.int32, device=dev)
    rows["500k"] = time_decode_kernel("500k", q, kv[0], kv[1], full, bw,
                                      flops, flush)
    emit("decode_deploy_kernel", case="500k", **rows["500k"])
    del kv, q
    # the MoE configs' layers at the 32k cache: Qwen2-MoE-A2.7B's Hkv = 16,
    # G = 1, and Qwen3-MoE-235B's Hkv = 4, G = 16 (the mma kernel's 16-row
    # instance)
    for case, arch in (("32k_g1", MOE_ARCH), ("32k_g16", MOE3_ARCH)):
        moe = get_config(arch)
        hkv, g = moe.n_kv_heads, moe.group_size
        kv = [torch.empty((b, s, hkv, d), dtype=dt, device=dev)
              .normal_(generator=gen) for _ in range(2)]
        q = torch.randn((b, hkv, g, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dt)
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        rows[case] = time_decode_kernel(f"32k G = {g}", q, kv[0], kv[1],
                                        full, bw, flops, flush)
        emit("decode_deploy_kernel", case=case, arch=moe.name, **rows[case])
        del kv, q
    del flush
    torch.cuda.empty_cache()
    return {"step": step, **rows}


# --------------------------------------------------------------------- #
# phase 12a: moe_block and moe_dispatch, the card against the host
# --------------------------------------------------------------------- #
# (name, T, E, K, n_shared, router_norm_topk, routing, zeroed tokens).
# A list routing gives each token's experts, the probes of the reference's
# scatter: token t is one-hot at t (D = T) and its router row holds 4.0 at
# its first expert and 2.0 at its second.  Probe 1: tokens 2 and 1 are
# kept at C-1 = 2 of experts 0 and 1 and lose the slot to the dropped
# assignments (3, 1) and (2, 1), so token 2 (whose other assignment is
# dropped) is zero; probe 2: the dropped (0, 1) on expert 0 has a smaller
# flat index than token 3's kept one, which survives; probe 3: token 3's
# drop zeroes the kept token 2.  "grid" draws x and the router on grids
# whose products are exact in float32 (x in k/8, |k| <= 8; the router in
# k/64, |k| <= 4; D = 256), so the logits, hence the routing, are the same
# bits on any device, at Qwen2-MoE's E and K and its widths' ratios.  The
# cases: no overflow, the three probes, the decode's T = 8 (C = 1), a T
# whose T·K/E·1.25 is an integer (48: C = 4), the shared expert and the
# renormalisation off, and T = 4,096.
MOE_SMALL_CASES = [
    ("no_overflow", 4, 8, 1, 0, True, [(0,), (1,), (2,), (3,)], []),
    ("probe_kept_overwritten", 4, 4, 2, 0, True,
     [(0, 1), (0, 1), (0, 1), (1, 0)], [2]),
    ("probe_kept_survives", 4, 4, 2, 0, True,
     [(1, 0), (0, 2), (0, 2), (0, 2)], []),
    ("probe_k1", 4, 2, 1, 0, True, [(0,)] * 4, [2, 3]),
    ("decode_c1", 8, 60, 4, 4, True, "grid", None),
    ("integer_capacity", 48, 60, 4, 4, True, "grid", None),
    ("no_shared_no_norm", 64, 60, 4, 0, False, "grid", None),
    ("t4096", 4096, 60, 4, 4, True, "grid", None),
]
MOE_GRID_D, MOE_GRID_F = 256, 176       # Qwen2-MoE's F/D = 1408/2048
# Card and host round the experts' products in other orders: the output
# is held by :func:`recsys_close` in its dtype, as the recsys phases are.


def moe_case(case, dtype: str):
    """(cfg, x [T, D], layer weights) of a MOE_SMALL_CASES entry on the
    host, in ``dtype``, drawn from the seed."""
    import torch
    from repro_torch.models.transformer import (MoEConfig,
                                                TransformerConfig)
    name, t, e, k, n_shared, norm, routing, _ = case
    rng = np.random.default_rng(SEED + t + e)
    if routing == "grid":
        d, f = MOE_GRID_D, MOE_GRID_F
        x = rng.integers(-8, 9, size=(t, d)) / 8.0
        router = rng.integers(-4, 5, size=(d, e)) / 64.0
    else:
        d, f = t, 8
        x = np.eye(t)
        router = np.zeros((d, e))
        for i, experts in enumerate(routing):
            for v, j in zip((4.0, 2.0), experts):
                router[i, j] = v
    fs = 4 * f
    cfg = TransformerConfig(
        name=f"moe-small-{name}", n_layers=1, d_model=d, n_heads=1,
        n_kv_heads=1, d_ff=f, vocab=8, dtype=dtype,
        moe=MoEConfig(n_experts=e, top_k=k, d_expert_ff=f,
                      n_shared=n_shared, d_shared_ff=fs if n_shared else 0,
                      router_norm_topk=norm))
    shapes = {"e_gate": (e, d, f), "e_up": (e, d, f), "e_down": (e, f, d)}
    if n_shared:
        shapes.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d),
                      s_gate_proj=(d, 1))
    lp = {n: rng.standard_normal(sh) / np.sqrt(sh[-2])
          for n, sh in shapes.items()}
    lp["router"] = router
    tdt = getattr(torch, dtype)
    return (cfg, torch.from_numpy(x.astype(np.float32)).to(tdt),
            {n: torch.from_numpy(w.astype(np.float32)).to(tdt)
             for n, w in lp.items()})


def dispatch_model(probs: np.ndarray, m):
    """The reference's dispatch written out in numpy loops, as a plain
    model of ``moe_dispatch``: top-K by a stable sort (ties to the lower
    index), the renormalisation added in slot order in float32, positions
    counted slot-major, then the scatter's updates applied one by one in
    row-major order of [T, K], the last one winning a slot; a dropped
    assignment writes the sentinel T at C-1.  → (top_p, top_e, pos, keep,
    idx_buf)."""
    from repro_torch.models.transformer import capacity
    t, e = probs.shape
    k, c = m.top_k, capacity(t, m)
    top_e = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    top_p = np.take_along_axis(probs, top_e, 1).astype(np.float32)
    if m.router_norm_topk:
        total = top_p[:, 0].copy()
        for j in range(1, k):
            total = total + top_p[:, j]
        top_p = top_p / np.maximum(total, np.float32(1e-9))[:, None]
    pos = np.zeros((t, k), np.int64)
    counts = np.zeros(e, np.int64)
    for j in range(k):
        for i in range(t):
            pos[i, j] = counts[top_e[i, j]]
            counts[top_e[i, j]] += 1
    keep = pos < c
    idx_buf = np.full((e, c), t, np.int64)
    for i in range(t):
        for j in range(k):
            idx_buf[top_e[i, j], min(pos[i, j], c - 1)] = \
                i if keep[i, j] else t
    return top_p, top_e, pos, keep, idx_buf


def dispatch_stats(top_e, pos, keep, idx_buf):
    """(assignments, dropped, kept ones whose slot holds another token or
    the sentinel — fault (t), experts chosen, experts whose buffer holds
    a token) of one dispatch, as device scalars."""
    import torch
    t, (e, c) = top_e.shape[0], idx_buf.shape
    held = idx_buf[top_e, pos.clamp(max=c - 1)]
    tok = torch.arange(t, device=top_e.device)[:, None]
    experts = torch.arange(e, device=top_e.device)
    return torch.stack([torch.full((), keep.numel(), device=keep.device),
                        (~keep).sum(), (keep & (held != tok)).sum(),
                        (top_e.reshape(-1, 1) == experts).any(0).sum(),
                        (idx_buf < t).any(1).sum()])


@contextlib.contextmanager
def patched_dispatch(wrap):
    """While open, every ``moe_dispatch(probs, m)`` that ``moe_block``
    makes returns ``wrap(real, probs, m)``, ``real`` being the function
    itself: the one hook that records, replays, counts or breaks the
    dispatch (phases 12a-12b and the tests)."""
    from repro_torch.models import transformer as T
    real = T.moe_dispatch
    T.moe_dispatch = lambda probs, m: wrap(real, probs, m)
    try:
        yield
    finally:
        T.moe_dispatch = real


def recorded_dispatches(log: list):
    """Append every dispatch's result to ``log`` while open (one a layer
    and step, in call order)."""
    def record(real, probs, m):
        log.append(real(probs, m))
        return log[-1]
    return patched_dispatch(record)


@contextlib.contextmanager
def kept_routing(routes: list):
    """Route each dispatch to the next of ``routes`` (``top_e`` tensors)
    while open: a replay of a recorded decode keeps its routes."""
    it = iter(routes)
    with patched_dispatch(lambda real, probs, m:
                          real(probs, m, top_e=next(it))):
        yield
    check(next(it, None) is None, "a replay took fewer routes than the "
                                  "decode recorded")


@contextlib.contextmanager
def dispatch_counts(dev):
    """Sum :func:`dispatch_stats` over every dispatch while open, on the
    device (no host sync)."""
    import torch
    counts = torch.zeros(5, dtype=torch.int64, device=dev)

    def count(real, probs, m):
        out = real(probs, m)
        counts.add_(dispatch_stats(*out[1:]))
        return out
    with patched_dispatch(count):
        yield counts


def same_dispatch(got, want) -> bool:
    """Two dispatches equal exactly: top_p bit for bit, the rest as
    integers."""
    import torch
    for a, b in zip(got, want):
        a = torch.as_tensor(a).cpu()
        b = torch.as_tensor(b).cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a.long(), b.long()):
            return False
    return True


def check_moe_case(dev, case, dtype: str) -> dict:
    """One MOE_SMALL_CASES entry in ``dtype``: moe_block on the card
    twice (the same bits) against the host within :func:`recsys_close`; the
    dispatch on the same probabilities exact against
    :func:`dispatch_model` on both, and on the card's own probabilities
    in everything but top_p's last bits; the probes' zeroed tokens zero.
    Raises on a failed check; returns the case's row."""
    import torch
    from repro_torch.models.transformer import moe_block, moe_dispatch
    name, t, _, _, _, _, routing, zeroed = case
    cfg, x, lp = moe_case(case, dtype)
    m = cfg.moe
    host = moe_block(x, lp, cfg)
    host64 = moe_block(x.double(), {n: w.double() for n, w in lp.items()},
                       cfg)
    xd, lpd = x.to(dev), {n: w.to(dev) for n, w in lp.items()}
    got = moe_block(xd, lpd, cfg)
    what = f"moe_block {name} {dtype}"
    check(same_bits(got, moe_block(xd, lpd, cfg)),
          f"{what}: two calls on the card differ")
    close = recsys_close(got, host, host64, dtype)
    check(close["ok"], f"{what}: {close}")
    probs = torch.softmax(torch.matmul(x.float(), lp["router"].float()),
                          dim=-1)
    want = dispatch_model(probs.numpy(), m)
    on_host = moe_dispatch(probs, m)
    on_card = moe_dispatch(probs.to(dev), m)
    check(same_dispatch(on_host, want) and same_dispatch(on_card, want),
          f"{what}: moe_dispatch differs from the reference's dispatch "
          f"(dispatch_model)")
    own = moe_dispatch(torch.softmax(torch.matmul(
        xd.float(), lpd["router"].float()), dim=-1), m)
    check(same_dispatch(own[1:], want[1:]),
          f"{what}: the card routes its own logits otherwise")
    routes, dropped, lost = (int(v) for v in
                             dispatch_stats(*on_host[1:])[:3])
    if zeroed is not None:
        for out in (host, got.cpu(), host64):
            zero = [i for i in range(t) if not bool(out[i].any())]
            check(zero == zeroed, f"{what}: tokens {zero} are zero, the "
                                  f"reference zeroes {zeroed}")
        check((dropped == 0) == (name == "no_overflow"),
              f"{what}: {dropped} assignments dropped")
    return dict(case=name, dtype=dtype, t=t, experts=m.n_experts,
                top_k=m.top_k, capacity=want[4].shape[1], shared=m.n_shared,
                norm=m.router_norm_topk, assignments=routes,
                dropped=dropped, kept_overwritten=lost, **close)


def phase_moe_small(dev) -> float:
    rows = [check_moe_case(dev, case, dtype) for case in MOE_SMALL_CASES
            for dtype in ("float32", "bfloat16")]
    _sync(dev)
    worst = max(r["max_abs_err"] for r in rows)
    emit("moe_small", cases=rows, max_abs_err=worst,
         tolerance=f"card vs host <= {RECSYS_RATIO} x the host's distance "
                   f"from its float64 run + 1 ulp; the dispatch exact against "
                   f"dispatch_model on both, given the same probabilities; "
                   f"two card calls the same bits",
         compared="moe_block and moe_dispatch on the card and on the host")
    return worst


# --------------------------------------------------------------------- #
# phase 12b: MoE decode serving, Qwen2-MoE-A2.7B at full width
# --------------------------------------------------------------------- #
MOE_ARCH = "qwen2-moe-a2.7b"
MOE3_ARCH = "qwen3-moe-235b-a22b"
# Qwen3-MoE-235B-A22B at full width (G = 64 / 4 = 16), cut in depth by the
# card's memory: its 94 layers are about 470 GB in bfloat16; 8 layers are
# 21.2 B parameters, 42.3 GB, which leaves room for the fp8 rounding in
# place, the float32 replay's widened layer and the cache
MOE3_LAYERS = 8
# Qwen3-MoE's prompts: the longest (245 tokens) and 16 new tokens take the
# cache past gqa_decode's first split (256 positions at 8 slots of 4 KV
# heads on an H100), so the served decode merges data from two splits;
# checked (min_splits)
MOE3_PROMPT_LENS = (64, 256)
# Qwen2-MoE-A2.7B's prompts: 64-256 tokens until Qwen3-MoE's phase 12c
# came, cut to 32-128 to keep the whole run under 600 s, and to 8-32 when
# phase dist came (PERF.md §4)
MOE_PROMPT_LENS = (8, 32)
MOE_MAX_NEW = 16
# The logit check of phase 11 compares the decode with a forward; an MoE
# forward over the same tokens routes T = B·S tokens at once and so has
# another capacity (8 slots at decode: C = 1; 8 × 261 positions: C = 174),
# which drops and overwrites other assignments: it is another function.
# The MoE reference is the same decode replayed in float32 (T = 8 a step,
# the same capacity) with the served decode's routing kept (each step's
# experts, recorded), attention by the plain version; the yardstick is
# the same replay in the model's dtype, and LOGIT_RATIO and TOP1_SLACK
# apply as in phase 11.  At the reference's init (ROADMAP fault (h)) the
# check is blind: there the bfloat16 replay agrees with the float32 one
# on the argmax of 1.5 % of the steps (5 % with the routing kept), and an
# fp8-weight replay falls inside the tolerance (on an H100, PERF.md §6).
# So the phase serves the model at the conditioned init of phase 11's second
# check (``condition_``: each matrix N(0, 1/d_in), each expert too), at
# full width and depth, where the same replays agree on 95 % of the
# argmaxes and the fp8 replay lies 8× the yardstick away.  Keeping the
# routing takes the routing flips of rounding (top-1 67 % when free) out
# of both sides; a decode whose error changes its routing still differs
# from a replay that computes the same routes correctly.


def step_bytes(model, slots: int, steps: int, experts=None) -> dict:
    """Bytes one decode step reads, on average over ``steps`` steps from
    an empty cache: every weight but the embedding, ``slots`` embedding
    rows, and each slot's K and V rows up to its position.  The experts'
    weights count whole (the gather formulation computes every expert)
    or, given ``experts``, for that many experts a layer (the mean number
    whose buffer holds a token: what the function needs)."""
    cfg = model.cfg
    elt = model.embed.element_size()
    weights = sum(p.numel() * p.element_size()
                  for p in model.parameters()) \
        - model.embed.numel() * elt + slots * cfg.d_model * elt
    if experts is not None:
        per_expert = sum(getattr(layer, n)[0].numel() * elt
                         for layer in model.layers
                         for n in ("e_gate", "e_up", "e_down"))
        weights -= (cfg.moe.n_experts - experts) * per_expert
    kv_rows = slots * (steps + 1) / 2          # mean of 1 .. steps
    kv = 2 * cfg.n_layers * kv_rows * cfg.n_kv_heads * cfg.head_dim * elt
    return {"weights": weights, "kv": kv, "total": weights + kv}


def moe_logit_check(model, fed, dec, slots: int, max_len: int,
                    routes=None):
    """Phase 12b's logit comparisons of the decode ``dec`` (logits [B, T,
    V], fed ``fed``): against the float32 replay of the same decode, of
    the same replay in the model's dtype (the yardstick) and, after
    rounding the weights to fp8 in place, of an fp8-weight replay; the
    first two with the plain attention, all three with the routing
    ``routes`` kept (each step's recorded experts), or free where it is
    None.  Returns the three :func:`logit_agreement` rows and the
    yardstick replay's dispatch counts (:func:`dispatch_counts`)."""
    import torch

    def routed():
        return (kept_routing(routes) if routes is not None
                else contextlib.nullcontext())
    with plain_attention(), routed():
        ref = replay(model, fed, slots, max_len, dtype=torch.float32)
    got = logit_agreement(dec, ref)
    with plain_attention(), routed(), dispatch_counts(ref.device) as counts:
        yardstick = logit_agreement(replay(model, fed, slots, max_len), ref)
    fp8_round_(model)
    with routed():
        fp8 = logit_agreement(replay(model, fed, slots, max_len), ref)
    return got, yardstick, fp8, counts


def moe3_config():
    """Qwen3-MoE-235B-A22B at full width with MOE3_LAYERS of its 94
    layers."""
    from repro_torch.configs.lm_family import get_config
    return dataclasses.replace(get_config(MOE3_ARCH), n_layers=MOE3_LAYERS)


def phase_moe_serve(dev, bw: float, cfg=None, slots: int = LM_SLOTS,
                    max_len: int = LM_MAX_LEN, lens=MOE_PROMPT_LENS,
                    max_new: int = MOE_MAX_NEW,
                    cond_layers: int = COND_LAYERS,
                    phase: str = "moe_serve", min_splits: int = 1) -> dict:
    import torch
    from repro_torch.configs.lm_family import get_config
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    from repro_torch.models.transformer import capacity, init_params
    from repro_torch.serve import LMServer
    cfg = cfg or get_config(MOE_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = init_params(cfg, gen, dev)
    condition_(model, gen)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = rag_prompts(cfg.vocab, slots, lens)
    server = LMServer(model, max_slots=slots, max_len=max_len, device=dev)
    runs, routes = [], []
    for call in range(2):
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with recorded_steps(server) as steps, \
                recorded_dispatches(routes if call == 0 else []):
            _sync(dev)
            gqa_kernel.launches = 0                 # this slice's path
            t0 = time.perf_counter()
            outs = server.generate(prompts, max_new=max_new)
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = gqa_kernel.launches          # ends here
        n_steps = len(steps)
        check(n_steps == max(map(len, prompts)) + max_new,
              f"MoE call {call}: {n_steps} decode steps")
        check(launches == _expected_launches(dev, cfg.n_layers * n_steps),
              f"MoE call {call}: gqa_decode launched {launches} times in "
              f"{n_steps} steps of {cfg.n_layers} layers")
        check(all(len(o) == max_new for o in outs)
              and all(0 <= t < cfg.vocab for o in outs for t in o),
              f"MoE call {call}: malformed output")
        runs.append(dict(
            seconds=seconds, steps=n_steps, launches=launches,
            ms_per_step=1e3 * seconds / n_steps,
            new_tokens_per_s=slots * max_new / seconds,
            tokens_per_s=slots * n_steps / seconds,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if torch.device(dev).type == "cuda" else None)))
        if call == 0:
            first, fed = outs, torch.stack([t for t, _ in steps], 1)
            dec = torch.stack([lg for _, lg in steps], 1)   # [B, T, V]
        del steps
    check(outs == first, "two MoE generate calls gave different tokens")
    check(bool(torch.isfinite(dec).all()), "non-finite MoE decode logits")
    server.cache = None
    n_steps = fed.shape[1]
    kv_splits = served_splits(dev, cfg, slots, max_len, n_steps)
    check(kv_splits is None or kv_splits["holding_data"] >= min_splits,
          f"{phase}: the served cache's data lies in fewer than "
          f"{min_splits} of gqa_decode's splits: {kv_splits}")

    routes = [out[1] for out in routes]
    t0 = time.perf_counter()
    got, rounding, fp8, counts = moe_logit_check(model, fed, dec, slots,
                                                 max_len, routes)
    replays_s = time.perf_counter() - t0
    n_routes, dropped, lost, chosen, held = (int(v) for v in counts)
    layer_steps = cfg.n_layers * n_steps
    gather = step_bytes(model, slots, n_steps)
    routed = step_bytes(model, slots, n_steps, held / layer_steps)
    del dec, model, server, routes
    logit_tol = LOGIT_RATIO * rounding["mean_abs"]
    top1_min = rounding["top1_agree"] - TOP1_SLACK
    gc.collect()
    cond = conditioned_check(dev, cfg, prompts, slots, max_len, max_new,
                             cond_layers)
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    m = cfg.moe
    row = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
               params=cfg.param_count(),
               active_params=cfg.active_param_count(),
               g=cfg.group_size, experts=m.n_experts, top_k=m.top_k,
               shared=m.n_shared, capacity=capacity(slots, m), slots=slots,
               max_len=max_len, prompt_lens=[len(p) for p in prompts],
               max_new=max_new, init_s=init_s, calls=runs,
               kv_splits=kv_splits, tokens_equal=True, gather_bytes=gather,
               gather_bound_ms=1e3 * gather["total"] / bw,
               ms_over_gather_bound=runs[1]["ms_per_step"] / (
                   1e3 * gather["total"] / bw),
               experts_chosen=chosen / layer_steps,
               experts_holding=held / layer_steps, routed_bytes=routed,
               routed_bound_ms=1e3 * routed["total"] / bw,
               ms_over_routed_bound=runs[1]["ms_per_step"] / (
                   1e3 * routed["total"] / bw),
               init="init_params, then condition_ (N(0, 1/d_in) a matrix "
                    "and an expert)",
               assignments_per_step=n_routes / n_steps,
               dropped_share=dropped / n_routes,
               kept_overwritten_share=lost / (n_routes - dropped),
               replays_s=replays_s, logits_vs_f32=got,
               plain_vs_f32=rounding, fp8_weights_vs_f32=fp8,
               mean_abs_tol=logit_tol, top1_min=top1_min,
               tolerance=f"decode mean |Δ| from the float32 replay (the "
                         f"decode's routing, plain attention) <= "
                         f"{LOGIT_RATIO} x the {cfg.dtype} replay's, top-1 "
                         f"agreement >= its - {TOP1_SLACK}",
               conditioned=cond)
    emit(phase, **row)
    check(got["mean_abs"] <= logit_tol and got["top1_agree"] >= top1_min,
          f"MoE decode logits vs the float32 replay: {got}, tolerance "
          f"{logit_tol}, top-1 >= {top1_min}")
    check(fp8["mean_abs"] > logit_tol or fp8["top1_agree"] < top1_min,
          f"the MoE tolerance passes an fp8-weight decode: {fp8}")
    return row


# --------------------------------------------------------------------- #
# phase 13: embedding_bag against its plain version at small shapes
# --------------------------------------------------------------------- #
# (name, V, D, B, L, dtype, ids): the reference kernel test's sweep, then
# D = 1 (xDeepFM's linear table), D = 10 (its embedding), D = 50
# (SASRec's), a bag of 33 (two rounds of the warp's 32 ids), B = 0,
# L = 0, all weights 0, ids in [-V, V), ids out of range (NaN rows),
# rows wider than one pass (scalar and vector), a table off 16 bytes
# (scalar loads), bfloat16 tables; then the launch plan's shapes: bags of
# one at D = 64 (B = 1,001, off every run of bags a warp takes) and at
# D = 16 (8 groups a warp), L = 26 (steps of 4 items), bfloat16 bags of
# one (4 groups a warp), L = 8 at D = 256 with B = 33 (serve_bulk's bag at
# a batch off the 8 warps of a block) and 20 scalar bfloat16 elements (the
# warp kernel below 32 vectors).  ids: "uniform" in [0, V), "wrap" in
# [-V, V), "bad" with a fifth outside [-V, V).
BAG_CASES = [
    ("sweep_100x32", 100, 32, 8, 5, "float32", "uniform"),
    ("sweep_1000x64", 1000, 64, 16, 20, "float32", "uniform"),
    ("sweep_64x128", 64, 128, 4, 3, "float32", "uniform"),
    ("d1", 50, 1, 7, 4, "float32", "uniform"),
    ("d10", 100, 10, 9, 6, "float32", "uniform"),
    ("d50_l33", 200, 50, 5, 33, "float32", "uniform"),
    ("b0", 100, 32, 0, 5, "float32", "uniform"),
    ("l0", 100, 32, 6, 0, "float32", "uniform"),
    ("zero_weights", 100, 32, 6, 5, "float32", "uniform"),
    ("negative_ids", 30, 16, 8, 6, "float32", "wrap"),
    ("out_of_range_ids", 30, 16, 8, 6, "float32", "bad"),
    ("d600_vec_2_passes", 300, 600, 5, 7, "float32", "uniform"),
    ("d130_scalar_2_passes", 300, 130, 5, 7, "float32", "uniform"),
    ("table_off_16_bytes", 100, 64, 8, 5, "float32", "uniform"),
    ("bf16_d64", 500, 64, 12, 8, "bfloat16", "uniform"),
    ("bf16_d10", 500, 10, 12, 8, "bfloat16", "uniform"),
    ("bf16_d1032_2_passes", 50, 1032, 3, 4, "bfloat16", "wrap"),
    ("bf16_out_of_range", 40, 24, 5, 6, "bfloat16", "bad"),
    ("bags_of_one_d64_b1001", 5000, 64, 1001, 1, "float32", "uniform"),
    ("bags_of_one_d16", 300, 16, 515, 1, "float32", "uniform"),
    ("l26_d64", 400, 64, 13, 26, "float32", "uniform"),
    ("bf16_bags_of_one_d64", 500, 64, 301, 1, "bfloat16", "uniform"),
    ("l8_d256_b33", 300, 256, 33, 8, "float32", "uniform"),
    ("bf16_d20_scalar_warp", 200, 20, 9, 3, "bfloat16", "uniform"),
]


def bag_case(name, v, d, b, l, dtype, ids):
    """Seeded (table [V, D], indices [B, L] int32, weights [B, L] f32) on
    the host."""
    import torch
    rng = np.random.default_rng(v * 31 + d * 7 + b + l)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(
        np.float32)).to(getattr(torch, dtype))
    lo = -v if ids in ("wrap", "bad") else 0
    idx = rng.integers(lo, v, size=(b, l))
    if ids == "bad":
        bad = rng.random((b, l)) < 0.2
        idx = np.where(bad, np.where(rng.random((b, l)) < 0.5, v + idx % 7,
                                     -v - 1 - idx % 7), idx)
    w = (rng.random((b, l)) < 0.8).astype(np.float32)
    if name == "zero_weights":
        w[:] = 0.0
    return (table, torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(w))


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits, with every NaN taken as one NaN."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    if torch.equal(a.view(view), b.view(view)):   # the same bits, NaNs too
        return True
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    return torch.equal(torch.where(na, 0, a).view(view),
                       torch.where(nb, 0, b).view(view))


def phase_bag_small(dev) -> float:
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_padded_ref,
                                                   kernel, take)
    cuda = torch.device(dev).type == "cuda"
    rows = []
    for case in BAG_CASES:
        name = case[0]
        table, idx, w = bag_case(*case)
        host = embedding_bag_padded_ref(table, idx, w)
        t = off_16(table, dev) if name == "table_off_16_bytes" \
            else table.to(dev)
        i, ww = idx.to(dev), w.to(dev)
        before = kernel.launches
        got = embedding_bag(t, i, ww)
        launched = kernel.launches - before
        check(launched == int(cuda and idx.shape[0] > 0),
              f"{name}: {launched} launches")
        want = embedding_bag_padded_ref(t, i, ww)
        check(same_bits(got, want) and same_bits(got.cpu(), host),
              f"embedding_bag {name}: differs from the plain version")
        check(bool(torch.isnan(got).any()) == (case[6] == "bad"),
              f"{name}: NaN rows where no id is out of range, or none")
        # bags of one of weight 1 are take, exactly
        flat = i.reshape(-1, 1)
        one = embedding_bag(t, flat, torch.ones(flat.shape,
                                                dtype=torch.float32,
                                                device=t.device))
        check(same_bits(one, take(t, flat[:, 0])),
              f"{name}: bags of one differ from take")
        rows.append(name)
    _sync(dev)
    emit("bag_small", cases=rows, max_abs_err=0.0,
         tolerance="bit for bit (NaN rows as NaN) against the plain version "
                   "on the card and on the host, float32 and bfloat16; bags "
                   "of one bit for bit against take")
    return 0.0


# --------------------------------------------------------------------- #
# phase 14: recsys serving, the fourth slice's main path
# --------------------------------------------------------------------- #
RECSYS_ARCHS = ("dlrm-rm2", "xdeepfm", "two-tower-retrieval", "sasrec")
RECSYS_TIMED = 10          # calls timed after the checked one
PROFILED_CALLS = 3         # calls in the profiled window
RECSYS_SAMPLE = 4096       # retrieval candidates the host recomputes
SASREC_CANDS = 64          # shared candidates of the scored serve_p99 batch
# Card and host both round the same sums in float32, in other orders: the
# card's output may be RECSYS_RATIO times as far from the host's as the
# host's float32 run is from its float64 run (the CPU tests measured the
# port's float32 error at up to 4.6 times JAX's, on DLRM's smoke config),
# plus one float32 ulp of the output's largest entry.
RECSYS_RATIO = 8.0
CLOSE_SCALE_SHARE = {"float32": 1e-3, "bfloat16": 2.0 ** -4}


def recsys_calls(name: str, cfg, batch: int, n_cand: int):
    """[(cell, numpy batch, launches per call)] that phase 14 serves for
    ``name``: the serve_p99 batch from the synth generator at the seed;
    for two-tower and SASRec also retrieval_cand (one query against
    ``n_cand`` ids cycling over the catalogue); for SASRec also the
    serve_p99 batch scoring shared candidates (fault (i) shows there)."""
    from repro_torch.configs.recsys_family import HIST_LEN
    from repro_torch.data import synth
    if name == "dlrm-rm2":
        return [("serve_p99", synth.dlrm_batch(
            SEED, batch, cfg.n_dense, cfg.n_sparse, cfg.vocab_per_table), 1)]
    if name == "xdeepfm":
        return [("serve_p99", synth.xdeepfm_batch(
            SEED, batch, cfg.n_sparse, cfg.vocab_per_table), 2)]
    cands = (np.arange(n_cand) % cfg.n_items).astype(np.int32)
    if name == "two-tower-retrieval":
        b = synth.twotower_batch(SEED, batch, cfg.n_users, cfg.n_items,
                                 HIST_LEN)
        q = synth.twotower_batch(SEED + 1, 1, cfg.n_users, cfg.n_items,
                                 HIST_LEN)
        one = {k: q[k] for k in ("user_ids", "hist_ids", "hist_w")}
        return [("serve_p99", b, 2),
                ("retrieval_cand", {**one, "cand_ids": cands}, 3)]
    b = synth.sasrec_batch(SEED, batch, cfg.seq_len, cfg.n_items)
    q = synth.sasrec_batch(SEED + 1, 1, cfg.seq_len, cfg.n_items)
    shared = (np.arange(SASREC_CANDS) % cfg.n_items).astype(np.int32)
    return [("serve_p99", {"item_seq": b["item_seq"]}, 1),
            ("serve_p99_scored", {"item_seq": b["item_seq"],
                                  "cand_ids": shared}, 2),
            ("retrieval_cand", {"item_seq": q["item_seq"],
                                "cand_ids": cands}, 2)]


# table leaves of each architecture, and the batch keys whose ids read them
RECSYS_TABLES = {
    "dlrm-rm2": {"tables": ("sparse",)},
    "xdeepfm": {"tables": ("sparse",), "linear": ("sparse",)},
    "two-tower-retrieval": {"user_table": ("user_ids",),
                            "item_table": ("hist_ids", "cand_ids")},
    "sasrec": {"item_embed": ("item_seq", "cand_ids")},
}
RECSYS_VOCAB = {"tables": "vocab_per_table", "linear": "vocab_per_table",
                "user_table": "n_users", "item_table": "n_items",
                "item_embed": "n_items"}


def host_subset(name: str, model, batch: dict):
    """The model on the CPU holding only the table rows that ``batch``
    reads (id 0 always, so SASRec's padding stays 0), and the batch with
    its ids renumbered into them: the same function of the same numbers on
    this batch, without a copy of 10 GB of tables."""
    import torch
    from repro_torch.models import recsys as R
    cfg, b, keep, sizes = model.cfg, dict(batch), {}, {}
    for leaf, keys in RECSYS_TABLES[name].items():
        keys = [k for k in keys if k in b]
        uniq = np.unique(np.concatenate(
            [[0]] + [np.asarray(batch[k]).ravel() for k in keys]))
        check(0 <= uniq[0] and uniq[-1] < getattr(cfg, RECSYS_VOCAB[leaf]),
              f"{name}: an id out of range in {keys}")
        for k in keys:
            b[k] = np.searchsorted(uniq, batch[k]).astype(np.int32)
        keep[leaf] = uniq
        sizes[RECSYS_VOCAB[leaf]] = len(uniq)
    host = R.make_model(dataclasses.replace(cfg, **sizes), "cpu")
    with torch.no_grad():
        for n, p in host.named_parameters():
            src = model.get_parameter(n)
            if n in keep:
                src = src.index_select(src.dim() - 2, torch.from_numpy(
                    keep[n]).to(src.device))
            p.copy_(src.cpu())
    return host, b


def recsys_close(got, want, want64, dtype: str = "float32") -> dict:
    """``got`` against the host's ``want`` (in ``dtype``) with the
    tolerance RECSYS_RATIO × max |want − want64| + one ulp of ``dtype`` at
    max |want|, which must stay below CLOSE_SCALE_SHARE of that entry."""
    scale = float(want.abs().max())
    host_err = float((want.double() - want64).abs().max())
    ulp = float(np.spacing(np.float32(scale))) if dtype == "float32" \
        else scale * 2.0 ** -8
    tol = RECSYS_RATIO * host_err + ulp
    err = float((got.cpu().double() - want.double()).abs().max())
    return {"max_abs_err": err, "tolerance": tol, "host_vs_f64": host_err,
            "scale": scale,
            "ok": bool(err <= tol <= CLOSE_SCALE_SHARE[dtype] * scale)}


def serve_timed(name, model, batch, dev, n):
    """Median host-clock ms of ``n`` synchronised serve calls."""
    from repro_torch.configs.recsys_family import serve
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        serve(name, model, batch)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def phase_recsys_serve(dev, smoke: bool = False, batch: int = None,
                       n_cand: int = None, timed: int = RECSYS_TIMED,
                       sample: int = RECSYS_SAMPLE) -> dict:
    import copy
    import torch
    from repro_torch.configs.recsys_family import (BATCHES, N_CAND,
                                                   get_config, serve)
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.models.recsys import init_params
    cuda = torch.device(dev).type == "cuda"
    batch = batch or BATCHES["serve_p99"]
    n_cand = n_cand or N_CAND
    out = {}
    for name in RECSYS_ARCHS:
        cfg = get_config(name, smoke=smoke)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = init_params(cfg, gen, dev)
        _sync(dev)
        row = {"card": nvidia_smi() if cuda else "cpu",
               "init_s": time.perf_counter() - t0,
               "table_gb": sum(p.numel() * p.element_size()
                               for n, p in model.named_parameters()
                               if n.split(".")[0] in RECSYS_VOCAB) / 1e9,
               "cells": {}}
        for cell, np_batch, per_call in recsys_calls(name, cfg, batch,
                                                      n_cand):
            _sync(dev)
            bag_kernel.launches = 0                 # the slice's main path
            got = serve(name, model, np_batch)
            _sync(dev)
            launches = bag_kernel.launches          # ends here
            check(launches == (per_call if cuda else 0),
                  f"{name} {cell}: embedding_bag launched {launches} times, "
                  f"expected {per_call}")
            check(bool(torch.isfinite(got).all()),
                  f"{name} {cell}: non-finite output")
            host_batch = dict(np_batch)
            cols = None
            if cell == "retrieval_cand":
                rng = np.random.default_rng(SEED + 3)
                cols = np.sort(rng.choice(len(np_batch["cand_ids"]),
                                          size=min(sample, len(
                                              np_batch["cand_ids"])),
                                          replace=False))
                host_batch["cand_ids"] = np_batch["cand_ids"][cols]
                got_cmp = got[:, torch.from_numpy(cols).to(got.device)]
            else:
                got_cmp = got
            host, sub = host_subset(name, model, host_batch)
            want = serve(name, host, sub)
            want64 = serve(name, copy.deepcopy(host).double(), sub)
            cmp = recsys_close(got_cmp, want, want64)
            c = {"batch": int(next(iter(np_batch.values())).shape[0]),
                 "shape": list(got.shape), "launches": launches,
                 "per_call": per_call, **cmp}
            if name == "sasrec" and "cand_ids" in np_batch:
                zero = (got == 0).all(-1).cpu()
                host_zero = (want == 0).all(-1)
                check(torch.equal(zero, host_zero),
                      f"sasrec {cell}: all-zero score rows differ from the "
                      f"host's")
                c["zero_score_rows"] = float(zero.float().mean())
                lens = (torch.as_tensor(np_batch["item_seq"]) != 0).sum(-1)
                c["zero_rows_are_2len_minus_1_lt_S"] = bool(torch.equal(
                    zero, 2 * lens - 1 < cfg.seq_len))
            check(cmp["ok"], f"{name} {cell}: {cmp['max_abs_err']} from the "
                             f"host, tolerance {cmp['tolerance']} (scale "
                             f"{cmp['scale']})")
            ms = serve_timed(name, model, np_batch, dev, timed)
            c.update(ms_per_call=ms, examples_per_s=1e3 * c["batch"] / ms)
            if cell == "retrieval_cand":
                c["candidates_per_s"] = 1e3 * got.shape[1] / ms
            if cuda:
                # the profiler drops the first kernel of a window now and
                # then (the bag launch often is that kernel): profile a few
                # calls and scale the kernel's mean time by its launches
                events, wall_ms = device_events(lambda: [
                    serve(name, model, np_batch)
                    for _ in range(PROFILED_CALLS)])
                device_ms = sum(e_ms for _, e_ms in events)
                bag = [e_ms for e, e_ms in events if "embedding_bag" in e]
                check(bool(bag), f"{name} {cell}: the profiler saw no "
                                 f"embedding_bag launch")
                bag_ms = float(np.mean(bag)) * per_call * PROFILED_CALLS
                c["profiled_calls"] = {
                    "calls": PROFILED_CALLS, "wall_ms": wall_ms,
                    "device_ms": device_ms,
                    "idle_share": 1 - device_ms / wall_ms,
                    "embedding_bag_events": len(bag),
                    "embedding_bag_ms": bag_ms}
                c["kernel_share_of_device"] = bag_ms / device_ms
            row["cells"][cell] = c
            del got, got_cmp, host, want, want64
        if cuda:
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = row
        emit("recsys_serve", arch=cfg.name, **row)
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# phase 15: embedding_bag at deployment width (serve_bulk, 262,144)
# --------------------------------------------------------------------- #
BULK = 262_144


def bag_bound(ids, d: int, elt: int, bw: float, flops: float,
              every_reference: bool = False):
    """(bound_ms, bound_by, bytes, rows) of a bag batch: each distinct row
    read once (``every_reference``: each of the B·L rows named, the floor
    where the L2 cannot hold the table), ids and weights (4 bytes each)
    read and the [B, D] output written once, over the memory rate; or its
    2·B·L·D float32 operations over the float32 rate."""
    import torch
    b, l = ids.shape
    rows = b * l if every_reference else int(torch.unique(ids).numel())
    nbytes = rows * d * elt + 8 * b * l + b * d * elt
    by_bytes = 1e3 * nbytes / bw
    by_ops = 1e3 * 2 * b * l * d / flops
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes, rows)


def bag_deploy_cases(dev, bulk: int = BULK, smoke: bool = False):
    """{case: (table, ids [B, L] int32, weights [B, L] f32, library)} at
    two-tower's and DLRM's serve_bulk widths, tables drawn on ``dev`` from
    the seed: the history bag over the 1 M × 256 item table with the synth
    batch's Zipf(1.3) ids and with uniform ids, and DLRM's field lookup as
    bags of one over its 26 tables viewed as [26 M, 64] with Zipf(1.2)
    ids (field f's ids offset by f·V).  ``library`` computes the same
    function with one PyTorch call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.recsys_family import HIST_LEN, get_config
    from repro_torch.data import synth
    tt = get_config("two-tower-retrieval", smoke=smoke)
    dl = get_config("dlrm-rm2", smoke=smoke)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    items = torch.randn((tt.n_items, tt.embed_dim), generator=gen,
                        device=dev) * 0.01
    hist = synth.twotower_batch(SEED, bulk, tt.n_users, tt.n_items, HIST_LEN)
    w = torch.from_numpy(hist["hist_w"]).to(dev)
    zipf = torch.from_numpy(hist["hist_ids"]).to(dev)
    uniform = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, tt.n_items, size=zipf.shape).astype(np.int32)).to(dev)

    def bag_library(table, ids, w):
        ids64 = ids.long()
        return lambda: F.embedding_bag(ids64, table, mode="sum",
                                       per_sample_weights=w)

    f, v = dl.n_sparse, dl.vocab_per_table
    tables = torch.empty((f * v, dl.embed_dim), device=dev)
    for i in range(f):                       # one field at a time
        tables[i * v:(i + 1) * v].normal_(0.0, 0.01, generator=gen)
    sparse = synth.dlrm_batch(SEED, bulk, dl.n_dense, f, v)["sparse"]
    flat = torch.from_numpy((sparse + np.arange(f) * v).astype(np.int32)
                            .reshape(-1, 1)).to(dev)
    ones = torch.ones(flat.shape, device=dev)
    flat64 = flat[:, 0].long()
    return {
        "uniform": (items, uniform, w, bag_library(items, uniform, w)),
        "zipf": (items, zipf, w, bag_library(items, zipf, w)),
        "dlrm": (tables, flat, ones, lambda: F.embedding(flat64, tables)),
    }


def bag_plan(table, ids) -> dict:
    """embedding_bag's launch plan for these inputs on this card."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.embedding_bag import kernel
    return kernel.plan(*ids.shape, table.shape[1], table.element_size(),
                       table.data_ptr() % 16 == 0,
                       sm_count(table.device))._asdict()


def phase_bag_deploy(dev, bw, flops, bulk: int = BULK) -> dict:
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_padded_ref)
    t0 = time.perf_counter()
    cases = bag_deploy_cases(dev, bulk)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for case, (table, ids, w, library) in cases.items():
        got = embedding_bag(table, ids, w)
        check(same_bits(got, embedding_bag_padded_ref(table, ids, w)),
              f"bag_deploy {case}: differs from the plain version")
        lib = library()
        lib_err = float((lib.reshape(got.shape) - got).abs().max())
        del got, lib
        # the kernel and the one library call in turns (A B B A)
        calls = {"kernel": lambda: embedding_bag(table, ids, w),
                 "library": library}
        ms, turns = time_in_turns(calls, flush=flush.zero_)
        device_ms = kernel_device_ms(calls["kernel"], "embedding_bag")
        plain_ms = time_cuda(lambda: embedding_bag_padded_ref(table, ids, w),
                             flush=flush.zero_)
        d, elt = table.shape[1], table.element_size()
        bound_ms, bound_by, nbytes, distinct = bag_bound(ids, d, elt, bw,
                                                         flops)
        refs_ms = bag_bound(ids, d, elt, bw, flops, every_reference=True)[0]
        kernel_ms = ms["kernel"]
        rows[case] = dict(
            card=nvidia_smi(), table=list(table.shape), shape=list(ids.shape),
            distinct_rows=distinct, max_abs_err=0.0, kernel_ms=kernel_ms,
            library_ms=ms["library"], turns_ms=turns,
            kernel_over_library=kernel_ms / ms["library"],
            kernel_device_ms=device_ms, plain_ms=plain_ms,
            library_call=("F.embedding" if case == "dlrm" else
                          "F.embedding_bag(mode='sum', per_sample_weights)"),
            library_max_abs_diff=lib_err, bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes,
            share_of_bound=bound_ms / kernel_ms, bound_refs_ms=refs_ms,
            share_of_refs_bound=refs_ms / kernel_ms,
            plan=bag_plan(table, ids))
        emit("bag_deploy", case=case, setup_s=setup_s, **rows[case])
    del cases, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------- #
# phase 16: embedding_bag's backward against its plain version
# --------------------------------------------------------------------- #
# (name, V, D, B, L, dtype, ids): "dup" names rows again within a bag and
# across bags; "wrap_bad" mixes ids in [-V, 0) with ids outside [-V, V);
# "nonfinite" puts inf, -inf and NaN in grad_out rows of bags that hold
# zero-weight items (fault (s)), an out-of-range id among them; "hot" names
# two rows far more than PIECE times; "runs" names rows exactly PIECE,
# PIECE + 1 and 2 · PIECE + 1 times, with no zero weight
BAG_BACKWARD_CASES = [
    ("dup_within_and_across_bags", 20, 64, 40, 6, "float32", "dup"),
    ("wrapped_and_dropped_ids", 30, 16, 24, 5, "float32", "wrap_bad"),
    ("zero_weights", 50, 32, 16, 4, "float32", "zero"),
    ("d10_not_a_multiple_of_4", 40, 10, 33, 3, "float32", "dup"),
    ("d7_bf16", 40, 7, 20, 4, "bfloat16", "wrap_bad"),
    ("bf16_d64", 100, 64, 64, 8, "bfloat16", "dup"),
    ("bf16_d256_bags_of_8", 300, 256, 50, 8, "bfloat16", "wrap_bad"),
    ("b0", 30, 16, 0, 4, "float32", "dup"),
    ("d256_bags_of_8", 500, 256, 65, 8, "float32", "dup"),
    ("bags_of_one_d64", 1000, 64, 777, 1, "float32", "dup"),
    ("d600_two_vectors_a_lane_and_more", 60, 600, 9, 3, "float32", "dup"),
    ("grad_out_off_16_bytes", 50, 64, 20, 4, "float32", "dup"),
    ("table_off_16_bytes_through_the_function", 50, 64, 20, 4, "float32",
     "dup"),
    ("nonfinite_zero_weights", 40, 64, 48, 8, "float32", "nonfinite"),
    ("nonfinite_zero_weights_bf16", 40, 64, 48, 8, "bfloat16", "nonfinite"),
    ("nonfinite_d7_scalar_loads", 30, 7, 40, 4, "float32", "nonfinite"),
    ("hot_rows_past_a_piece", 200, 256, 300, 8, "float32", "hot"),
    ("hot_rows_bags_of_one", 5000, 64, 4000, 1, "float32", "hot"),
    ("runs_of_c_and_c_plus_1", 100, 64, 64, 4, "float32", "runs"),
]


def bag_backward_case(name, v, d, b, l, dtype, ids):
    """Seeded (grad_out [B, D], indices [B, L] int32, weights [B, L] f32)
    on the host."""
    import torch
    from repro_torch.kernels.embedding_bag import PIECE
    rng = np.random.default_rng(v * 13 + d * 5 + b + l)
    g = rng.standard_normal((b, d)).astype(np.float32)
    if ids == "dup":
        idx = rng.integers(0, max(v // 4, 1), size=(b, l))
        if b:
            idx[:, -1] = idx[:, 0]                 # again within the bag
    elif ids in ("hot", "nonfinite"):
        idx = rng.integers(0, v, size=(b, l))
        if ids == "hot":                           # rows 3 and v - 1
            idx[rng.random((b, l)) < 0.4] = 3
            idx[rng.random((b, l)) < 0.1] = -1
    elif ids == "runs":
        # rows 0-2 named PIECE, PIECE + 1 and 2 · PIECE + 1 times, in bags
        # spread over the batch; the other items name rows 3.. once or twice
        idx = 3 + rng.permutation(b * l) % (v - 3)
        named = np.repeat([0, 1, 2], [PIECE, PIECE + 1, 2 * PIECE + 1])
        idx[rng.choice(b * l, size=named.size, replace=False)] = named
        idx = idx.reshape(b, l)
    else:
        idx = rng.integers(-v, v, size=(b, l))
        if ids == "wrap_bad":
            bad = rng.random((b, l)) < 0.25
            idx = np.where(bad, np.where(rng.random((b, l)) < 0.5,
                                         v + idx % 5, -v - 1 - idx % 5), idx)
    w = rng.standard_normal((b, l)).astype(np.float32)
    if ids != "runs":
        w[rng.random((b, l)) < 0.2] = 0.0
    if ids == "zero":
        w[:] = 0.0
    if ids == "nonfinite":
        # bags 0-3 hold zero weights and inf, -inf, NaN; bag 1 only zero
        # weights; bag 2 also an out-of-range id of weight 0 (dropped);
        # bag 4 an inf with no zero weight; bag 5 zero weights, all finite
        w[:6, 0] = 0.0
        w[1] = 0.0
        idx[2, 1], w[2, 1] = v + 2, 0.0
        idx[3, -1] = idx[0, -1]        # a row of an inf bag named again
        g[0, 1], g[1, 2], g[2, 3] = np.inf, np.nan, -np.inf
        g[3, 0], g[3, d - 1] = np.nan, np.inf
        w[4] = np.where(w[4] == 0, 1.5, w[4])
        g[4, d // 2] = np.inf
    return (torch.from_numpy(g).to(getattr(torch, dtype)),
            torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(w))


def bag_backward_bound(g, idx, w, num_rows):
    """Per element of the table's gradient, what a float32 sum of its n
    terms (every item of an id in range) in another order may differ by:
    n · 2^-23 · Σ|terms| (and for a bfloat16 gradient, one bfloat16 ulp of
    the value more: the float32 sums may round to either side of a
    bfloat16 boundary)."""
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_ref
    mag = embedding_bag_backward_ref(g.float().abs(), idx, w.abs(), num_rows)
    ids = idx.long().reshape(-1)
    keep = (ids >= -num_rows) & (ids < num_rows)
    rows = torch.where(ids < 0, ids + num_rows, ids)[keep]
    n = torch.bincount(rows, minlength=num_rows).to(torch.float32)
    return n[:, None] * 2.0 ** -23 * mag


def bag_backward_close(got, want, bound) -> tuple:
    """(max |got − want| over the finite elements of want, the bound
    there, ok) in float32: ok where got has NaN where want has, the same
    inf where want has one, and each finite element within the bound (plus
    one bfloat16 ulp of the value for a bfloat16 gradient)."""
    import torch
    tol = bound.float()
    if got.dtype == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -8
    got, want = got.float(), want.float()
    fin, inf = torch.isfinite(want), torch.isinf(want)
    ok = (torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(got[inf], want[inf]))
    err, tol = (got - want).abs()[fin], tol[fin]
    return (float(err.max()) if err.numel() else 0.0,
            float(tol.max()) if tol.numel() else 0.0,
            ok and bool((err <= tol).all()))


def phase_bag_backward_small(dev) -> float:
    """The backward kernel on the card against the plain model of its order
    (``embedding_bag_backward_sorted_ref``), bit for bit with equal NaN
    masks, twice (the same bits); and against the item-order plain version
    within :func:`bag_backward_bound`, on the card and on the host.  On the
    CPU the wrapper is the item-order plain version, which the sorted model
    meets within the bound (and bit for bit on rows named at most PIECE
    times: tests/test_torch_train_recsys.py)."""
    import torch
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward, embedding_bag_backward_ref,
        embedding_bag_backward_sorted_ref, embedding_bag_padded, kernel)
    cuda = torch.device(dev).type == "cuda"
    rows, worst = [], 0.0
    for case in BAG_BACKWARD_CASES:
        name, v, d, b, l, dtype = case[:6]
        g, idx, w = bag_backward_case(*case)
        dt = getattr(torch, dtype)
        host = embedding_bag_backward_ref(g, idx, w, v).to(dt)
        i, ww = idx.to(dev), w.to(dev)
        gd = off_16(g, dev) if name == "grad_out_off_16_bytes" else g.to(dev)
        bound = bag_backward_bound(g, idx, w, v).to(dev)
        before = kernel.backward_launches
        if name == "table_off_16_bytes_through_the_function":
            table = off_16(torch.zeros((v, d), dtype=dt), dev)
            table.requires_grad_(True)
            (embedding_bag_padded(table, i, ww) * gd).sum().backward()
            got = table.grad
        else:
            got = embedding_bag_backward(gd, i, ww, v)
        launched = kernel.backward_launches - before
        check(launched == int(cuda and b > 0),
              f"{name}: {launched} backward launches")
        again = embedding_bag_backward(gd, i, ww, v)
        check(same_bits(got, again), f"{name}: two calls differ")
        sorted_ = embedding_bag_backward_sorted_ref(gd, i, ww, v).to(dt)
        exact = same_bits(got, sorted_)
        check(exact or not cuda, f"embedding_bag backward {name}: the "
                                 f"kernel differs from its sorted model")
        want = embedding_bag_backward_ref(gd, i, ww, v).to(dt)
        err, tol_d, ok = bag_backward_close(got, want, bound)
        err_h, tol_h, ok_h = bag_backward_close(got.cpu(), host, bound.cpu())
        err_s, _, ok_s = bag_backward_close(sorted_.cpu(), host,
                                            bound.cpu())
        check(ok and ok_h and ok_s,
              f"embedding_bag backward {name}: |Δ| {err} / {err_h} (sorted "
              f"model {err_s}) beyond the bound {tol_d} / {tol_h}")
        check(got.dtype == dt and tuple(got.shape) == (v, d),
              f"{name}: gradient {got.dtype} {tuple(got.shape)}")
        nonfinite = not bool(torch.isfinite(g).all())
        check(nonfinite == bool(torch.isnan(got).any()),
              f"{name}: NaN in the gradient: {bool(torch.isnan(got).any())}")
        worst = max(worst, err, err_h)
        rows.append({"case": name, "max_abs_err": max(err, err_h),
                     "bound": max(tol_d, tol_h), "sorted_model_bits": exact,
                     "nan": int(torch.isnan(got).sum())})
    _sync(dev)
    emit("bag_backward_small", cases=rows, max_abs_err=worst,
         tolerance="bit for bit against the sorted model with equal NaN "
                   "masks, and two calls equal, on the card; per element "
                   "|Δ| ≤ n · 2^-23 · Σ|terms| over the row's n terms "
                   "against the item-order plain version (plus one bfloat16 "
                   "ulp of the value for a bfloat16 gradient), NaN and inf "
                   "where it has them, on the card and on the host")
    return worst


# --------------------------------------------------------------------- #
# phase 17: the index-backed LM trainer at InternLM2-1.8B width
# --------------------------------------------------------------------- #
LM_TRAIN_ARCH = "internlm2-1.8b"
LM_TRAIN_BATCH = 4           # train_4k's global 256 cut to what one card holds
LM_TRAIN_STEPS = 3
LM_TRAIN_CHUNK = 1024        # attn_chunk_q = attn_chunk_kv
LM_TRAIN_DOCS = 16
LM_TRAIN_DOC_LEN = 8192      # mean words a document: 4,096-token windows
BF16_PEAK = 989e12           # H100 SXM dense bf16 (data sheet)


def lm_train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 6 · params · tokens, plus causal attention's
    6 · layers · heads · head_dim · seq / 2 · 2 a token."""
    return 6.0 * cfg.param_count() * tokens + \
        6.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq * tokens


def timed_step_fn(step_fn, dev, stamps: list):
    """``step_fn`` that synchronises and stamps the host clock after each
    step (the step time; the trainer itself reads nothing back)."""
    def fn(model, opt, batch):
        out = step_fn(model, opt, batch)
        _sync(dev)
        stamps.append(time.perf_counter())
        return out
    return fn


def phase_train_lm(dev, arch: str = LM_TRAIN_ARCH, smoke: bool = False,
                   batch: int = LM_TRAIN_BATCH, seq: int = None,
                   steps: int = LM_TRAIN_STEPS, n_docs: int = LM_TRAIN_DOCS,
                   doc_len: int = LM_TRAIN_DOC_LEN,
                   chunk: int = LM_TRAIN_CHUNK) -> dict:
    """The port's pipeline over seeded long documents, then
    ``IndexedCorpusLoader``, then ``Trainer`` on the model at full width in
    bfloat16 with remat and blocked attention, ``steps`` steps; then two
    steps on one repeated batch, whose loss must fall."""
    import torch
    from repro_torch.configs.lm_family import SHAPES, get_config, loss_fn
    from repro_torch.core import DynamicIndex, Warren
    from repro_torch.data.pipeline import (IndexedCorpusLoader, ingest,
                                           mark_duplicates, segment)
    from repro_torch.data.synth import doc_generator
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cuda = torch.device(dev).type == "cuda"
    seq = seq or SHAPES["train_4k"]["seq"]
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), remat=True,
                              attn_chunk_q=chunk, attn_chunk_kv=chunk)
    t0 = time.perf_counter()
    warren = Warren(DynamicIndex())
    n = ingest(warren, doc_generator(SEED, n_docs, mean_len=doc_len))
    dups = mark_duplicates(warren)
    segs = segment(warren, window=seq, stride=seq // 2)
    loader = IndexedCorpusLoader(warren, vocab=cfg.vocab, batch=batch,
                                 seq_len=seq, seed=SEED)
    pipeline_s = time.perf_counter() - t0
    check(segs >= batch * (steps + 1) + 8,
          f"{segs} segments do not last {steps + 1} steps without a wrap")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    tc = TrainerConfig(total_steps=steps, ckpt_dir=None, log_every=1,
                       ckpt_every=steps + 1,
                       opt=AdamWConfig(lr=1e-3, warmup_steps=0,
                                       total_steps=100))
    trainer = Trainer(loss_fn, model, tc, loader,
                      data_state_fn=loader.state,
                      data_restore_fn=loader.restore)
    stamps = []
    trainer.step_fn = timed_step_fn(trainer.step_fn, dev, stamps)
    t0 = time.perf_counter()
    out = trainer.train()
    step_ms = 1e3 * np.diff([t0] + stamps)
    losses = [m["loss"] for m in out["metrics"]]
    check(out["step"] == steps and all(np.isfinite(losses)),
          f"LM training: {out}")
    consumed = trainer._consumed_data_state
    check(consumed == {"cursor": batch * steps, "epoch": 0},
          f"the data cursor is {consumed}, expected {batch * steps}")
    # two steps on one repeated batch (from a loader of its own: the
    # trainer's prefetch thread still holds the first): its loss falls
    rep = {k: torch.as_tensor(v, device=dev) for k, v in next(
        IndexedCorpusLoader(warren, vocab=cfg.vocab, batch=batch,
                            seq_len=seq, seed=SEED + 1)).items()
           if k in ("tokens", "labels")}
    opt, m1 = trainer.step_fn(model, trainer.opt_state, rep)
    second = []
    # the second step under the profiler on the card: its idle share and
    # its device time by kernel
    profiled = (device_busy(lambda: second.append(
        trainer.step_fn(model, opt, rep))) if cuda else
        second.append(trainer.step_fn(model, opt, rep)))
    m2 = second[0][1]
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    check(l2 < l1, f"the loss on a repeated batch did not fall: {l1} → {l2}")
    steady = float(np.median(step_ms[1:])) if steps > 1 else float(
        step_ms[0])
    tokens = batch * seq
    row = {"card": nvidia_smi() if cuda else "cpu", "arch": cfg.name,
           "params": sum(p.numel() for p in model.parameters()),
           "dtype": cfg.dtype, "remat": cfg.remat, "chunk": chunk,
           "batch": batch, "seq": seq, "docs": n, "dups": dups,
           "segments": segs, "pipeline_s": pipeline_s, "init_s": init_s,
           "steps": steps, "step_ms": step_ms.tolist(),
           "steady_step_ms": steady, "tokens_per_s": 1e3 * tokens / steady,
           "losses": losses, "repeated_batch_losses": [l1, l2],
           "profiled_step": profiled,
           "data_state": consumed,
           "model_flops_per_step": lm_train_flops(cfg, tokens, seq)}
    row["model_flops_share_of_bf16_peak"] = (
        row["model_flops_per_step"] / (steady / 1e3) / BF16_PEAK)
    if cuda:
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit("train_lm", **row)
    del trainer, model, opt, rep, second
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------- #
# phase 18: the checkpoint path on the card, at the smoke config
# --------------------------------------------------------------------- #
TRAIN_SMALL_STEPS = 10
TRAIN_SMALL_CRASH = 7
TRAIN_SMALL_BATCH = 2
TRAIN_RATIO = 8.0
FLIP_STEP = 2.5      # the most one AdamW step moves a coordinate, in lr


def small_lm_trainer(dev, ckpt_dir, steps=TRAIN_SMALL_STEPS, lr=1e-3,
                     restored: list = None):
    """make_trainer for the index-backed smoke LM (30 documents, 32-token
    windows, batches of TRAIN_SMALL_BATCH) on ``dev``, the weights drawn on
    the host; each data state a trainer restores is appended to
    ``restored``."""
    import torch
    from repro_torch.configs.lm_family import get_config, loss_fn
    from repro_torch.core import DynamicIndex, Warren
    from repro_torch.data.pipeline import (IndexedCorpusLoader, ingest,
                                           mark_duplicates, segment)
    from repro_torch.data.synth import doc_generator
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(LM_TRAIN_ARCH, smoke=True)
    warren = Warren(DynamicIndex())
    ingest(warren, doc_generator(SEED, 30, mean_len=60))
    mark_duplicates(warren)
    segment(warren, window=32, stride=16)

    def make():
        loader = IndexedCorpusLoader(warren, vocab=cfg.vocab,
                                     batch=TRAIN_SMALL_BATCH, seq_len=32)

        def restore(state):
            if restored is not None:
                restored.append(dict(state))
            loader.restore(state)
        tc = TrainerConfig(total_steps=steps, ckpt_every=3,
                           ckpt_dir=ckpt_dir, log_every=1,
                           opt=AdamWConfig(lr=lr, warmup_steps=2,
                                           total_steps=steps))
        model = init_params(cfg, torch.Generator().manual_seed(SEED),
                            "cpu").to(dev)
        return Trainer(loss_fn, model, tc, loader,
                       data_state_fn=loader.state, data_restore_fn=restore)
    return make


def params_close(got: dict, ref32: dict, ref64: dict, lr: float,
                 steps: int) -> dict:
    """Parameters after ``steps`` AdamW steps against a float32 run and its
    float64 twin: the mean |Δ| of each leaf within TRAIN_RATIO × the
    float32 run's mean distance from float64 plus one ulp, and each
    element within TRAIN_RATIO × that distance's largest entry or what two
    runs that move a coordinate in opposite directions can differ by
    (2 · FLIP_STEP · lr a step)."""
    worst, flip = {}, 2 * FLIP_STEP * lr * steps
    for n, a in ref32.items():
        a = a.double()
        d = (got[n].double().cpu() - a).abs()
        spread = (a - ref64[n].double()).abs()
        ulp = float(np.spacing(np.float32(float(a.abs().max()))))
        ok = (float(d.mean()) <= TRAIN_RATIO * float(spread.mean()) + ulp
              and float(d.max()) <= max(TRAIN_RATIO * float(spread.max())
                                        + ulp, flip))
        check(ok, f"parameter {n}: mean |Δ| {float(d.mean())}, max "
                  f"{float(d.max())}; spread mean {float(spread.mean())}, "
                  f"max {float(spread.max())}")
        worst[n] = float(d.max())
    return {"max_abs_err": max(worst.values()), "flip_bound": flip}


def host_runs(make):
    """The same training on the CPU in float32 and with the model widened to
    float64 (the optimizer stays float32): {name: tensor} each."""
    out = []
    for wide in (False, True):
        tr = make("cpu")
        if wide:
            tr.model.double()
        tr.train()
        out.append({n: p.detach().clone()
                    for n, p in tr.model.named_parameters()})
    return out


def phase_train_small(dev) -> dict:
    """``run_with_restarts`` with an injected crash on the card: the resumed
    run restores the cursor of the step it resumes at and reaches
    total_steps, its parameters equal an uninterrupted card run's bit for
    bit (the same kernels on the same inputs in the same order: the LM
    path has no atomics), and 3 card steps agree with 3 CPU steps of the
    port, float32 with TF32 off."""
    import tempfile

    import torch
    from repro_torch.train.trainer import run_with_restarts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 1e-3
    restored = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        whole = run_with_restarts(small_lm_trainer(
            dev, os.path.join(tmp, "a")))
        crashed = run_with_restarts(small_lm_trainer(
            dev, os.path.join(tmp, "b"), restored=restored),
            fail_at=TRAIN_SMALL_CRASH)
        saved = sorted(os.listdir(os.path.join(tmp, "b")))
    check(whole.step == crashed.step == TRAIN_SMALL_STEPS,
          f"steps {whole.step} and {crashed.step}")
    # checkpoints are written asynchronously: the restart finds step 6's,
    # or (not yet published) an earlier one, and restores its cursor
    resumed_at = crashed.metrics_log[0]["step"] - 1
    check(resumed_at in (0, 3, 6), f"the restart resumed at {resumed_at}")
    cursor = restored[-1] if restored else {"cursor": 0, "epoch": 0}
    check(len(restored) == int(resumed_at > 0) and cursor == {
        "cursor": TRAIN_SMALL_BATCH * resumed_at, "epoch": 0},
        f"resumed at step {resumed_at}, the cursors restored: {restored}")
    diff, same = 0.0, True
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              crashed.model.named_parameters()):
        a, b = a.detach(), b.detach()
        diff = max(diff, float((a - b).abs().max()))
        same = same and torch.equal(a, b)
    check(same, f"the resumed run is {diff} from the whole run, not bit "
                f"for bit")
    # 3 card steps against 3 host steps, and the host's float64 twin
    steps = 3

    def make(d):
        return small_lm_trainer(d, None, steps=steps, lr=lr)()
    card = make(dev)
    card.train()
    got = {n: p.detach() for n, p in card.model.named_parameters()}
    ref32, ref64 = host_runs(make)
    cmp = params_close(got, ref32, ref64, lr, steps)
    row = {"steps": TRAIN_SMALL_STEPS, "crash_at": TRAIN_SMALL_CRASH,
           "resumed_at": resumed_at, "checkpoints": saved,
           "restored_cursor": cursor, "resumed_vs_whole_max_abs": diff,
           "resumed_bit_for_bit": same,
           "card_vs_host_3_steps": cmp,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    emit("train_small", **row)
    return row


# --------------------------------------------------------------------- #
# phase 19: recsys training at DLRM-RM2 and two-tower width
# --------------------------------------------------------------------- #
RECSYS_TRAIN_STEPS = 3
TWOTOWER_LOSS_CHUNK = 4096
# embedding_bag launches (forward, backward) a training step
TRAIN_LAUNCHES = {"dlrm-rm2": 1, "xdeepfm": 2, "two-tower-retrieval": 3,
                  "sasrec": 3}


def recsys_trainer(name, cfg, model, batch, steps, lr=1e-3):
    """A Trainer over ``steps`` copies of one batch (the loss on a repeated
    batch must fall)."""
    from repro_torch.configs.recsys_family import loss_fn
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tc = TrainerConfig(total_steps=steps, ckpt_dir=None, log_every=1,
                       ckpt_every=steps + 1,
                       opt=AdamWConfig(lr=lr, warmup_steps=0,
                                       total_steps=100))
    return Trainer(lambda m, b: loss_fn(name, m, b), model, tc,
                   iter([batch] * steps))


def step_lookups(name, model, batch) -> list:
    """One training step's lookups of ``name``: [(table, ids int32,
    weights f32, grad_out)] for each call of embedding_bag_padded in its
    loss, grad_out the gradient autograd hands the lookup's output (the
    tables' gradients are not taken)."""
    import torch
    from repro_torch.configs.recsys_family import loss_fn
    from repro_torch.kernels.embedding_bag import ops
    seen, inner = [], ops.embedding_bag_padded

    def record(table, indices, weights):
        out = inner(table, indices, weights)
        seen.append((table.detach(), indices.to(torch.int32).contiguous(),
                     weights.to(torch.float32).contiguous(), out))
        return out
    ops.embedding_bag_padded = record
    try:
        loss = loss_fn(name, model, batch)
    finally:
        ops.embedding_bag_padded = inner
    grads = torch.autograd.grad(loss, [s[3] for s in seen])
    return [(t, i, w, g) for (t, i, w, _), g in zip(seen, grads)]


def check_lookups(name, model, batch) -> list:
    """Each of one step's lookups (:func:`step_lookups`) through the
    forward kernel, bit for bit against its plain version, and its
    gradient through the backward kernel against its plain version within
    :func:`bag_backward_bound` and, on the card, bit for bit against the
    plain model of the kernel's order."""
    import torch
    from repro_torch.kernels.embedding_bag import (
        embedding_bag, embedding_bag_backward, embedding_bag_backward_ref,
        embedding_bag_backward_sorted_ref, embedding_bag_padded_ref)
    rows = []
    for k, (t, i, w, g) in enumerate(step_lookups(name, model, batch)):
        v = t.shape[0]
        fwd = same_bits(embedding_bag(t, i, w),
                        embedding_bag_padded_ref(t, i, w))
        check(fwd, f"{name} lookup {k}: the forward kernel differs from "
                   f"its plain version")
        got = embedding_bag_backward(g, i, w, v)
        exact = None
        if g.is_cuda:
            exact = same_bits(got, embedding_bag_backward_sorted_ref(
                g, i, w, v).to(got.dtype))
            check(exact, f"{name} lookup {k}: the backward kernel differs "
                         f"from its sorted model")
        want = embedding_bag_backward_ref(g, i, w, v).to(got.dtype)
        err, tol, ok = bag_backward_close(got, want,
                                          bag_backward_bound(g, i, w, v))
        check(ok, f"{name} lookup {k}: the backward kernel is {err} from "
                  f"its plain version, beyond {tol}")
        rows.append({"table": list(t.shape), "dtype": str(t.dtype),
                     "shape": list(i.shape), "forward_bit_for_bit": fwd,
                     "backward_sorted_model_bits": exact,
                     "backward_max_abs_err": err, "backward_bound": tol})
        del got, want
        if g.is_cuda:
            torch.cuda.empty_cache()
    return rows


def phase_train_recsys(dev, smoke: bool = False, batch: int = None,
                       steps: int = RECSYS_TRAIN_STEPS) -> dict:
    """DLRM-RM2 and two-tower at full width (``smoke``: their smoke
    configs) at train_batch, a few steps on one repeated batch through
    ``Trainer``, with every lookup's forward and backward kernel counted;
    then all four models at their smoke configs, 3 card steps against 3
    host steps."""
    import torch
    from repro_torch.configs.recsys_family import (BATCHES, get_config,
                                                   smoke_batch, train_batch)
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.models.recsys import init_params
    cuda = torch.device(dev).type == "cuda"
    batch = batch or BATCHES["train_batch"]
    out = {}
    for name in ("dlrm-rm2", "two-tower-retrieval"):
        cfg = get_config(name, smoke=smoke)
        if name == "two-tower-retrieval":
            cfg = dataclasses.replace(cfg, loss_chunk=min(
                TWOTOWER_LOSS_CHUNK, batch))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        t0 = time.perf_counter()
        model = init_params(cfg, gen, dev)
        _sync(dev)
        init_s = time.perf_counter() - t0
        b = train_batch(name, cfg, batch, seed=SEED)
        trainer = recsys_trainer(name, cfg, model, b, steps)
        stamps = []
        trainer.step_fn = timed_step_fn(trainer.step_fn, dev, stamps)
        _sync(dev)
        bag_kernel.launches = bag_kernel.backward_launches = 0   # path
        t0 = time.perf_counter()
        res = trainer.train()
        _sync(dev)
        fwd, bwd = bag_kernel.launches, bag_kernel.backward_launches  # ends
        per = TRAIN_LAUNCHES[name]
        check(fwd == bwd == (per * steps if cuda else 0),
              f"{name}: {fwd} forward and {bwd} backward launches in "
              f"{steps} steps, expected {per * steps} each")
        losses = [m["loss"] for m in res["metrics"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{name}: the loss on a repeated batch did not fall: "
              f"{losses}")
        step_ms = 1e3 * np.diff([t0] + stamps)
        steady = float(np.median(step_ms[1:]))
        row = {"card": nvidia_smi() if cuda else "cpu", "arch": cfg.name,
               "batch": batch, "steps": steps, "init_s": init_s,
               "table_gb": sum(p.numel() * p.element_size()
                               for n, p in model.named_parameters()
                               if n.split(".")[0] in RECSYS_VOCAB) / 1e9,
               "step_ms": step_ms.tolist(), "steady_step_ms": steady,
               "examples_per_s": 1e3 * batch / steady, "losses": losses,
               "launches": fwd, "backward_launches": bwd,
               "launches_per_step": fwd / steps,
               "backward_launches_per_step": bwd / steps}
        if name == "two-tower-retrieval":
            row["loss_chunk"] = cfg.loss_chunk
        if cuda:
            row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            # one more step on the batch under the profiler
            row["profiled_step"] = device_busy(lambda: trainer.step_fn(
                model, trainer.opt_state, b))
            if not smoke and name == "two-tower-retrieval":
                check(row["peak_mem_gb"] < 60,
                      f"two-tower peak memory {row['peak_mem_gb']} GB")
        # each lookup of one more step at its own shapes, through both
        # kernels against their plain versions (the optimizer state freed
        # first: DLRM's gradients are [26 M, 64] each)
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        row["lookups"] = check_lookups(name, model, b)
        check(len(row["lookups"]) == TRAIN_LAUNCHES[name],
              f"{name}: {len(row['lookups'])} lookups a step")
        out[name] = row
        emit("train_recsys", **row)
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    # all four at their smoke configs: 3 card steps against 3 host steps
    out["smoke_card_vs_host"] = {}
    for name in RECSYS_ARCHS:
        cfg = get_config(name, smoke=True)
        b = smoke_batch(name, "train", seed=SEED)

        def make(d, name=name, cfg=cfg, b=b):
            m = init_params(cfg, torch.Generator().manual_seed(SEED),
                            "cpu").to(d)
            return recsys_trainer(name, cfg, m, b, 3)
        card = make(dev)
        bag_kernel.launches = bag_kernel.backward_launches = 0
        card.train()
        _sync(dev)
        launches = (bag_kernel.launches, bag_kernel.backward_launches)
        per = TRAIN_LAUNCHES[name] * 3 if cuda else 0
        check(launches == (per, per), f"{name} smoke: launches {launches}")
        got = {n: p.detach() for n, p in card.model.named_parameters()}
        ref32, ref64 = host_runs(make)
        cmp = params_close(got, ref32, ref64, 1e-3, 3)
        out["smoke_card_vs_host"][name] = {**cmp, "launches": launches}
    emit("train_recsys_smoke", **out["smoke_card_vs_host"])
    return out


# --------------------------------------------------------------------- #
# phase 20: embedding_bag's backward at DLRM's and two-tower's train width
# --------------------------------------------------------------------- #
def bag_backward_deploy_cases(dev, batch: int = None, smoke: bool = False):
    """{case: (grad_out [B, D], ids [B, L] int32, weights [B, L] f32,
    num_rows, uniform ids or None)} at train_batch: DLRM's field lookup as
    65,536 × 26 bags of one over the 26 tables viewed as [26 M, 64]
    (Zipf(1.2) ids, field f's offset by f·V), and two-tower's history bags
    [65,536, 8] over the 1 M × 256 item table (Zipf(1.3), and the same
    bags with uniform ids: what the skew costs); grad_out drawn on ``dev``
    from the seed."""
    import torch
    from repro_torch.configs.recsys_family import (BATCHES, HIST_LEN,
                                                   get_config)
    from repro_torch.data import synth
    batch = batch or BATCHES["train_batch"]
    dl = get_config("dlrm-rm2", smoke=smoke)
    tt = get_config("two-tower-retrieval", smoke=smoke)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    f, v = dl.n_sparse, dl.vocab_per_table
    sparse = synth.dlrm_batch(SEED, batch, dl.n_dense, f, v)["sparse"]
    flat = torch.from_numpy((sparse + np.arange(f) * v).astype(np.int32)
                            .reshape(-1, 1)).to(dev)
    hist = synth.twotower_batch(SEED, batch, tt.n_users, tt.n_items,
                                HIST_LEN)
    uniform = np.random.default_rng(SEED + 5).integers(
        0, tt.n_items, size=hist["hist_ids"].shape).astype(np.int32)
    return {
        "dlrm": (torch.randn((flat.shape[0], dl.embed_dim), generator=gen,
                             device=dev), flat,
                 torch.ones(flat.shape, device=dev), f * v, None),
        "two_tower_hist": (
            torch.randn((batch, tt.embed_dim), generator=gen, device=dev),
            torch.from_numpy(hist["hist_ids"]).to(dev),
            torch.from_numpy(hist["hist_w"]).to(dev), tt.n_items,
            torch.from_numpy(uniform).to(dev)),
    }


def bag_backward_bytes(g, ids, w):
    """(bytes, distinct rows): grad_out, ids and weights read once, each
    distinct row named with a non-zero weight read and written once in
    float32."""
    import torch
    named = ids.reshape(-1)[w.reshape(-1) != 0]
    rows = int(torch.unique(named).numel())
    return (g.numel() * g.element_size() + 8 * ids.numel()
            + 2 * rows * g.shape[1] * 4, rows)


def bag_backward_kept(g, ids, w, v):
    """The rows of the items the kernel sorts, in item order: an id in
    range, with a weight other than 0 or a non-finite grad_out row."""
    import torch
    flat = ids.long().reshape(-1)
    bag = torch.arange(flat.numel(), device=flat.device) // ids.shape[1]
    bad = ~torch.isfinite(g).all(1)
    keep = ((flat >= -v) & (flat < v)
            & ((w.reshape(-1) != 0) | bad[bag]))
    return torch.where(flat < 0, flat + v, flat)[keep]


def bag_backward_stats(g, ids, w, v) -> dict:
    """What the kernel's order makes of these inputs: the kept items, their
    runs (one a distinct row), the long runs (more than PIECE items), the
    pieces, the later pieces (rows of scratch) and the longest run."""
    import torch
    from repro_torch.kernels.embedding_bag import PIECE
    counts = torch.unique(bag_backward_kept(g, ids, w, v),
                          return_counts=True)[1]
    pieces = (counts + PIECE - 1) // PIECE
    return {"kept": int(counts.sum()), "runs": int(counts.numel()),
            "long_runs": int((pieces > 1).sum()),
            "pieces": int(pieces.sum()),
            "scratch_rows": int((pieces - 1).sum()),
            "longest_run": int(counts.max()) if counts.numel() else 0}


# the backward's kernels, by the part of the work they do
BACKWARD_PARTS = {"keys": ("keys",),
                  "sort": ("sort_hist", "sort_scan", "sort_scatter"),
                  "reduction": ("runs_count", "runs_write", "reduce"),
                  "combine": ("combine",)}


def backward_split(fn, g, ids, v) -> dict:
    """The backward call's device time: every ``embedding_bag_backward_*``
    kernel of a call summed, each kernel's own mean and each part's
    (:data:`BACKWARD_PARTS`), from the profiler."""
    import torch
    from repro_torch.device import sm_count
    from repro_torch.kernels.embedding_bag import kernel
    p = kernel.backward_plan(ids.numel(), v, g.shape[1], g.element_size(),
                             g.data_ptr() % 16 == 0, sm_count(g.device))
    per_call = {k: (p.passes if k.startswith("sort") else 1)
                for part in BACKWARD_PARTS.values() for k in part}
    ms = kernels_device_ms(lambda: (fn(), None)[1], kernel.BACKWARD,
                           per_call)
    return {"device_ms": ms["total"], "passes": p.passes,
            "parts_ms": {part: sum(ms[k] for k in names)
                         for part, names in BACKWARD_PARTS.items()},
            "kernels_ms": {k: ms[k] for k in per_call}}


def phase_bag_backward_deploy(dev, bw, flops, batch: int = None,
                              smoke: bool = False) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (
        PIECE, embedding_bag_backward, embedding_bag_backward_ref,
        embedding_bag_backward_sorted_ref)
    cases = bag_backward_deploy_cases(dev, batch, smoke)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}

    def held(case, g, ids, w, v):
        # the sorted model bit for bit and two calls equal, then the
        # item-order plain version within the bound
        got = embedding_bag_backward(g, ids, w, v)
        check(same_bits(got, embedding_bag_backward(g, ids, w, v)),
              f"bag_backward_deploy {case}: two calls differ")
        check(same_bits(got, embedding_bag_backward_sorted_ref(g, ids, w,
                                                               v)),
              f"bag_backward_deploy {case}: the kernel differs from its "
              f"sorted model")
        want = embedding_bag_backward_ref(g, ids, w, v)
        err, tol, ok = bag_backward_close(got, want,
                                          bag_backward_bound(g, ids, w, v))
        check(ok, f"bag_backward_deploy {case}: |Δ| {err} beyond {tol}")
        return err, tol

    def bound_of(g, ids, w):
        nbytes, distinct = bag_backward_bytes(g, ids, w)
        by_bytes = 1e3 * nbytes / bw
        by_ops = 1e3 * 2 * ids.numel() * g.shape[1] / flops
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations", nbytes,
                distinct)

    def sort_ms_of(g, ids, w, v):
        # torch.sort(stable=True) of the kept items' rows, every device
        # activity of the call
        keys = bag_backward_kept(g, ids, w, v).to(torch.int32)
        return all_device_ms(lambda: torch.sort(keys, stable=True))

    for case, (g, ids, w, v, uniform) in cases.items():
        err, tol = held(case, g, ids, w, v)
        # the library: autograd's backward of F.embedding_bag (dense)
        table = torch.zeros((v, g.shape[1]), device=dev, requires_grad=True)
        out = F.embedding_bag(ids.long(), table, mode="sum",
                              per_sample_weights=w)

        def library():
            return torch.autograd.grad(out, table, g, retain_graph=True)[0]
        lib_err = float((library() - embedding_bag_backward(
            g, ids, w, v)).abs().max())
        calls = {"kernel": lambda: embedding_bag_backward(g, ids, w, v),
                 "library": library}
        if uniform is not None:
            calls["kernel_uniform_ids"] = lambda: embedding_bag_backward(
                g, uniform, w, v)
        ms, turns = time_in_turns(calls, flush=flush.zero_)
        split = backward_split(calls["kernel"], g, ids, v)
        plain_ms = time_cuda(lambda: embedding_bag_backward_ref(g, ids, w, v),
                             flush=flush.zero_)
        bound_ms, bound_by, nbytes, distinct = bound_of(g, ids, w)
        rows[case] = dict(
            card=nvidia_smi(), table=[v, g.shape[1]],
            shape=list(ids.shape), distinct_rows=distinct, c=PIECE,
            **bag_backward_stats(g, ids, w, v),
            max_abs_err=err, tolerance=tol, sorted_model_bits=True,
            ms=ms["kernel"], kernel_ms=ms["kernel"],
            kernel_device_ms=split["device_ms"],
            parts_ms=split["parts_ms"], kernels_ms=split["kernels_ms"],
            sort_passes=split["passes"],
            sort_ms=split["parts_ms"]["sort"],
            library_sort_ms=sort_ms_of(g, ids, w, v),
            library_ms=ms["library"], turns_ms=turns,
            kernel_over_library=ms["kernel"] / ms["library"],
            library_call="torch.autograd.grad of F.embedding_bag(mode='sum', "
                         "per_sample_weights) (dense)",
            library_sort="torch.sort(stable=True) of the kept items' int32 "
                         "rows, every device activity of the call",
            library_max_abs_diff=lib_err, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, share_of_bound=bound_ms / ms["kernel"],
            device_share_of_bound=bound_ms / split["device_ms"],
            zero_fill_ms=1e3 * v * g.shape[1] * 4 / bw)
        if uniform is not None:
            # the same bags with uniform ids, timed in the same turns
            u_err, u_tol = held(case + "_uniform_ids", g, uniform, w, v)
            u_bound, u_by, u_bytes, u_distinct = bound_of(g, uniform, w)
            u_split = backward_split(calls["kernel_uniform_ids"], g, uniform,
                                     v)
            rows[case]["uniform_ids"] = dict(
                distinct_rows=u_distinct,
                **bag_backward_stats(g, uniform, w, v),
                max_abs_err=u_err, tolerance=u_tol,
                kernel_ms=ms["kernel_uniform_ids"],
                kernel_device_ms=u_split["device_ms"],
                parts_ms=u_split["parts_ms"],
                bound_ms=u_bound, bound_by=u_by, bytes=u_bytes,
                zipf_over_uniform=ms["kernel"] / ms["kernel_uniform_ids"],
                zipf_over_uniform_device=(split["device_ms"]
                                          / u_split["device_ms"]))
        emit("bag_backward_deploy", case=case, **rows[case])
        del table, out
    del cases, flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------- #
# phases 21-22: NequIP, graph serving (no kernel of the repository: its
# message passing is index_add, the reference's segment_sum)
# --------------------------------------------------------------------- #
# minibatch_lg: the reference's cell samples 1,024 seeds at fanout 15-10
# from a 232,965-node graph (Reddit's node count, the reference's
# gnn_family.py docstring).  Reddit's 114.6 M edges are cut to mean degree
# 25 (5,824,125 edges; 50 until the mesh slice's phase dist) to keep the
# host's graph build and sampler index short; fanout 15 needs a degree of
# at least 15.
GNN_PARENT_NODES = 232_965
GNN_PARENT_EDGES = 5_824_125     # mean degree 25 (50 until phase dist)
GNN_SEEDS = 1_024
GNN_FANOUTS = (15, 10)
GNN_MOLECULES = (128, 30, 64)     # molecule: graphs, nodes and edges each
GNN_TIMED = 10                    # calls timed after the checked one


def gnn_rotation(seed: int = SEED + 5) -> np.ndarray:
    """A random proper rotation [3, 3] (QR of a seeded Gaussian, det +1),
    as the reference's equivariance test draws one."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def gnn_call(model, task: str, b: dict) -> dict:
    """One NequIP call on the tensors ``b``: ``classify``'s logits, or
    ``energy_and_forces``' energies and forces."""
    from repro_torch.models import nequip as NQ
    if task == "classify":
        return {"logits": NQ.classify(model, b["positions"], b["species"],
                                      b["senders"], b["receivers"],
                                      b.get("node_feats"))}
    e, f = NQ.energy_and_forces(model, b["positions"], b["species"],
                                b["senders"], b["receivers"],
                                b["graph_ids"], b["n_graphs"])
    return {"energies": e, "forces": f}


def gnn_tensors(batch: dict, dev, dtype=None) -> dict:
    """A numpy graph batch as tensors on ``dev``, float arrays in
    ``dtype`` where one is given; scalars as they are."""
    import torch
    out = {}
    for k, v in batch.items():
        if np.isscalar(v):
            out[k] = v
            continue
        t = torch.as_tensor(v, device=dev)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return out


def gnn_rotated(batch: dict, rot: np.ndarray) -> dict:
    """The batch with every position rotated by ``rot`` (x → R x)."""
    return dict(batch, positions=(batch["positions"].astype(np.float64)
                                  @ rot.T).astype(np.float32))


def gnn_check(dev, model, task: str, batch: dict, rot: np.ndarray,
              what: str) -> dict:
    """``task`` on the card against the same function on the host in
    float32 and float64 (``recsys_close``), on ``batch`` and on it rotated;
    then on the card the rotation leaves logits and energies unchanged and
    rotates the forces, within RECSYS_RATIO × the host's float32-vs-
    float64 distance on the two inputs plus one float32 ulp of the
    output's scale (the rotated output taken back in float64); forces
    finite."""
    import copy
    import torch
    host = copy.deepcopy(model).cpu()
    host64 = copy.deepcopy(host).double()
    rows = {}
    outs = {}
    for name, b in (("input", batch), ("rotated", gnn_rotated(batch, rot))):
        got = gnn_call(model, task, gnn_tensors(b, dev))
        want = gnn_call(host, task, gnn_tensors(b, "cpu"))
        want64 = gnn_call(host64, task, gnn_tensors(b, "cpu", torch.float64))
        outs[name] = (got, want, want64)
        for key in got:
            check(bool(torch.isfinite(got[key]).all()),
                  f"{what} {name}: non-finite {key}")
            cmp = recsys_close(got[key], want[key], want64[key])
            check(cmp["ok"], f"{what} {name} {key}: {cmp['max_abs_err']} "
                             f"from the host, tolerance {cmp['tolerance']} "
                             f"(scale {cmp['scale']})")
            rows[f"{name}_{key}"] = cmp
    r = torch.as_tensor(rot, dtype=torch.float64)
    for key in outs["input"][0]:
        got, want, want64 = outs["input"]
        rgot, rwant, rwant64 = outs["rotated"]
        a, b = got[key].double().cpu(), rgot[key].double().cpu()
        if key == "forces":
            a = a @ r.T                     # F(R x) = R F(x)
        host_err = float((want[key].double() - want64[key]).abs().max()
                         + (rwant[key].double() - rwant64[key]).abs().max())
        scale = float(want64[key].abs().max())
        tol = RECSYS_RATIO * host_err + float(np.spacing(np.float32(scale)))
        err = float((a - b).abs().max())
        check(err <= tol, f"{what} {key}: the card's output moves {err} "
                          f"under a rotation, tolerance {tol}")
        rows[f"rotation_{key}"] = {"max_abs_err": err, "tolerance": tol,
                                   "host_vs_f64": host_err, "scale": scale}
    return rows


def gnn_close(got, want, want64) -> dict:
    """``recsys_close``, where a leaf that is zero on the host in float32
    and float64 (a gradient no path reaches: a layer's ``gate2`` acts on
    l = 2 features that start at zero, and the last layer's on features
    nothing reads) must be exactly zero on the card."""
    if float(want64.abs().max()) == 0.0 and float(want.abs().max()) == 0.0:
        err = float(got.abs().max())
        return {"max_abs_err": err, "tolerance": 0.0, "host_vs_f64": 0.0,
                "scale": 0.0, "ok": err == 0.0}
    return recsys_close(got, want, want64)


def gnn_loss_check(dev, model, batch: dict, what: str) -> dict:
    """``loss_fn``'s value and gradients on the card against the host's in
    float32 and float64, each leaf by ``recsys_close``."""
    import copy
    import torch
    from repro_torch.configs.gnn_family import loss_fn
    rows = {}
    grads = []
    for m, dtype in ((copy.deepcopy(model), None),
                     (copy.deepcopy(model).cpu(), None),
                     (copy.deepcopy(model).cpu().double(), torch.float64)):
        m.requires_grad_(True)
        loss = loss_fn(m, gnn_tensors(batch, m.device, dtype))
        loss.backward()
        grads.append({"loss": loss.detach()[None],
                      **{n: p.grad for n, p in m.named_parameters()}})
    for n in grads[0]:
        check(bool(torch.isfinite(grads[0][n]).all()),
              f"{what}: non-finite gradient of {n}")
        cmp = gnn_close(grads[0][n], grads[1][n], grads[2][n])
        check(cmp["ok"], f"{what} {n}: {cmp['max_abs_err']} from the host, "
                         f"tolerance {cmp['tolerance']}")
        rows[n] = cmp["max_abs_err"]
    return rows


def gnn_self_loop(batch: dict) -> dict:
    """The molecule batch with its first edge made a self loop (a
    zero-length edge, as padding makes)."""
    senders = batch["senders"].copy()
    senders[0] = batch["receivers"][0]
    return dict(batch, senders=senders)


def phase_gnn_small(dev) -> dict:
    """NequIP's smoke config on the card against the host, both tasks:
    node classification on the smoke graph, energies and forces on the
    smoke molecules (one self loop among their edges), each also rotated,
    and ``loss_fn``'s gradients of both."""
    import torch
    from repro_torch.configs.gnn_family import (NEQUIP_SMOKE, cfg_for_cell,
                                                gnn_smoke_batch)
    from repro_torch.models.nequip import init_params
    rot = gnn_rotation()
    out = {}
    for task, cfg in (("classify", NEQUIP_SMOKE),
                      ("energy_and_forces",
                       cfg_for_cell(NEQUIP_SMOKE, "molecule"))):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = init_params(cfg, gen, dev)
        batch = gnn_smoke_batch(cfg, "train", seed=SEED)
        if task != "classify":
            batch = gnn_self_loop(batch)
        out[task] = {"outputs": gnn_check(dev, model, task, batch, rot,
                                          f"gnn_small {task}"),
                     "loss_grads": gnn_loss_check(dev, model, batch,
                                                  f"gnn_small {task} loss")}
    _sync(dev)
    emit("gnn_small", config=NEQUIP_SMOKE.name, **out,
         tolerance=f"card vs host <= {RECSYS_RATIO} x the host's distance "
                   f"from float64 + 1 ulp; under a rotation the same rule "
                   f"on the host's distances at both inputs")
    return out


def gnn_timed(model, task: str, b: dict, dev, n: int = GNN_TIMED) -> float:
    """ms a call (host clock, synchronised) of ``task`` on tensors already
    on ``dev``, the median of ``n`` calls."""
    ms = []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        gnn_call(model, task, b)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def phase_gnn_serve(dev, cfg=None, parent=(GNN_PARENT_NODES,
                                           GNN_PARENT_EDGES),
                    seeds: int = GNN_SEEDS, fanouts=GNN_FANOUTS,
                    molecules=GNN_MOLECULES, timed: int = GNN_TIMED) -> dict:
    """NequIP at its full config (5 layers, 32 channels a irrep order) on
    two cells: minibatch_lg (``classify`` on a 1,024-seed, fanout 15-10
    sample of a 232,965-node graph, 602 features, 41 classes) and molecule
    (``energy_and_forces`` on 128 molecules of 30 nodes and 64 edges); each
    card against the host and rotated (:func:`gnn_check`); ms a call,
    nodes/s and graphs/s, peak memory."""
    import torch
    from repro_torch.configs.gnn_family import NEQUIP, cfg_for_cell
    from repro_torch.data.synth import (NeighborSampler, molecule_batch,
                                        random_graph)
    from repro_torch.models.nequip import init_params
    cfg = cfg or NEQUIP
    cuda = torch.device(dev).type == "cuda"
    rot = gnn_rotation()
    out = {}

    # minibatch_lg: the parent graph and its sampler index on the host
    cell_cfg = cfg_for_cell(cfg, "minibatch_lg")
    t0 = time.perf_counter()
    g = random_graph(SEED, parent[0], parent[1], d_feat=cell_cfg.d_feat,
                     n_classes=cell_cfg.n_classes)
    sampler = NeighborSampler(parent[0], g["senders"], g["receivers"])
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 7)
    seed_nodes = rng.choice(parent[0], seeds, replace=False)
    t0 = time.perf_counter()
    sub = sampler.sample(seed_nodes, list(fanouts), rng)
    sample_ms = 1e3 * (time.perf_counter() - t0)
    nodes = sub["nodes"]
    batch = {"positions": g["positions"][nodes],
             "species": g["species"][nodes],
             "node_feats": g["node_feats"][nodes],
             "senders": sub["senders"], "receivers": sub["receivers"]}
    del g, sampler
    molecules_batch = molecule_batch(SEED, *molecules)
    for cell, task, c, b, items in (
            ("minibatch_lg", "classify", cell_cfg, batch, seeds),
            ("molecule", "energy_and_forces", cfg_for_cell(cfg, "molecule"),
             molecules_batch, molecules[0])):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = init_params(c, gen, dev)
        row = {"config": c.name, "d_feat": c.d_feat,
               "n_classes": c.n_classes, "params": c.param_count(),
               "nodes": int(len(b["positions"])),
               "edges": int(len(b["senders"]))}
        row["checks"] = gnn_check(dev, model, task, b, rot, cell)
        tb = gnn_tensors(b, dev)
        ms = gnn_timed(model, task, tb, dev, timed)
        row.update(ms_per_call=ms, nodes_per_s=1e3 * row["nodes"] / ms,
                   peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                                if cuda else None))
        if cell == "minibatch_lg":
            row.update(parent_nodes=parent[0], parent_edges=parent[1],
                       seeds=seeds, fanouts=list(fanouts),
                       seeds_per_s=1e3 * items / ms, graph_build_s=build_s,
                       sample_ms=sample_ms)
        else:
            row.update(graphs=items, graphs_per_s=1e3 * items / ms)
        out[cell] = row
        emit("gnn_serve", cell=cell, **row)
        del model, tb
    if cuda:
        torch.cuda.empty_cache()
    return out


# phase 23: the one-card dry run held against real steps (slice 9), and
# each real step's kernel launches
DRYRUN_CELLS = {("internlm2-1.8b", "long_500k"): {"gqa_decode": 24},
                ("dlrm-rm2", "serve_p99"): {"embedding_bag": 1},
                ("nequip", "molecule"): {}}
DRYRUN_SHARE = 0.05          # an estimate within 5 % of the measured peak,
DRYRUN_FLOOR = 256 << 20     # or within 256 MiB, whichever is larger
DISPATCH_CALLS = 2000        # calls a turn of dispatch_cost


def dispatch_cost(dev, calls: int = DISPATCH_CALLS) -> dict:
    """Host µs a call of gqa_decode (at lm_serve's decode: 8 slots,
    Qwen2.5-14B's 8 KV heads of 5 query heads, a 1,024-row cache) and of
    embedding_bag (512 bags of 26 items over a [1000, 64] table: a small
    lookup, so the call's host time shows) through the operator
    and through its eager body (the wrapper before it became one), in
    turns (op, body, body, op), synchronised before and after each turn:
    what the dispatcher adds to a call."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    dt = torch.bfloat16 if torch.device(dev).type == "cuda" else \
        torch.float32
    q = torch.randn((8, 8, 5, 128), generator=g, device=dev).to(dt)
    k, v = (torch.randn((8, 1024, 8, 128), generator=g, device=dev).to(dt)
            for _ in range(2))
    length = torch.full((8,), 700, dtype=torch.int32, device=dev)
    table = torch.randn((1000, 64), generator=g, device=dev)
    ids = torch.randint(0, 1000, (512, 26), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.ones((512, 26), device=dev)

    def host_us(fn) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / calls
        _sync(dev)
        return us
    out = {}
    for name, op, args in (("gqa_decode", gqa_kernel.gqa_decode,
                            (q, k, v, length)),
                           ("embedding_bag", bag_kernel.embedding_bag,
                            (table, ids, w))):
        body = op._init_fn
        host_us(lambda: op(*args))                  # warm
        turns = [host_us(lambda: op(*args)), host_us(lambda: body(*args)),
                 host_us(lambda: body(*args)), host_us(lambda: op(*args))]
        out[name] = {"op_us": [turns[0], turns[3]],
                     "body_us": [turns[1], turns[2]],
                     "added_us": (turns[0] + turns[3] - turns[1]
                                  - turns[2]) / 2}
    emit("dispatch", **out)
    return out


def estimate_holds(estimate: float, measured: float) -> bool:
    """The dry run's memory check: ``estimate`` within DRYRUN_SHARE of
    ``measured`` or DRYRUN_FLOOR bytes, whichever is larger."""
    return abs(estimate - measured) <= max(DRYRUN_SHARE * measured,
                                           DRYRUN_FLOOR)


def phase_dryrun(dev, cells=DRYRUN_CELLS, seed: int = SEED,
                 configs: dict = None) -> dict:
    """Each cell's dry run (``launch.dryrun.run_cell``) on fakes of
    ``dev``, then the same step for real at full width (the model and
    inputs from ``seed``; a decode cache at length S − 1), held to it: the
    estimated peak within :func:`estimate_holds` of the allocator's peak
    above what was allocated before the cell was built, the real step's
    FLOP count equal to the fake one, and, for a cell with a KV cache, the
    estimate without the cache refused.  gqa_decode's and embedding_bag's
    launch counts are zeroed just before the real step and read just
    after, and must be ``cells``' (every other kernel's 0).  ``configs``
    maps an arch to a config to run in place of its full one (the CPU
    tests' small sizes)."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.gqa_decode import kernel as gqa_kernel
    from repro_torch.launch.dryrun import run_cell
    cuda = torch.device(dev).type == "cuda"
    out = {}
    for (arch, shape), want in cells.items():
        cfg = (configs or {}).get(arch)
        fake = run_cell(arch, shape, dev, cfg)
        check(fake["ok"], f"dry run of {arch}/{shape}: "
              f"{fake.get('traceback', '')}")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        gqa_kernel.launches = 0                     # the real step's path
        bag_kernel.launches = bag_kernel.backward_launches = 0
        real = run_cell(arch, shape, dev, cfg, seed=seed)
        launches = {"gqa_decode": gqa_kernel.launches,          # ends here
                    "embedding_bag": bag_kernel.launches,
                    "embedding_bag_backward": bag_kernel.backward_launches}
        check(real["ok"], f"real step of {arch}/{shape}: "
              f"{real.get('traceback', '')}")
        check(launches == {k: want.get(k, 0) for k in launches},
              f"{arch}/{shape}: launches {launches}, want {want}")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        est = fake["memory"]["peak_bytes"]
        got = real["memory"].get("allocator_peak_bytes",
                                 real["memory"]["peak_bytes"])
        row = {"estimate_bytes": est, "measured_bytes": got,
               "ratio": est / got, "fits": fake["fits"],
               "capacity_bytes": fake["capacity_bytes"],
               "flops": fake["cost"]["flops"],
               "real_flops": real["cost"]["flops"],
               "bytes_accessed": fake["cost"]["bytes accessed"],
               "argument_bytes": fake["memory"]["argument_bytes"],
               "temp_bytes": fake["memory"]["temp_bytes"],
               "tracked_real_bytes": real["memory"]["peak_bytes"],
               "trace_s": fake["trace_s"], "real_step_s": real["trace_s"],
               "launches": launches}
        check(estimate_holds(est, got),
              f"{arch}/{shape}: estimate {est:.0f} B, measured {got:.0f} B")
        check(row["flops"] == row["real_flops"],
              f"{arch}/{shape}: {row['flops']} FLOPs faked, "
              f"{row['real_flops']} real")
        if "cache_bytes" in fake:
            row["without_cache_bytes"] = est - fake["cache_bytes"]
            row["without_cache_refused"] = not estimate_holds(
                row["without_cache_bytes"], got)
            check(row["without_cache_refused"],
                  f"{arch}/{shape}: the check passes an estimate without "
                  f"the KV cache")
        out[f"{arch}/{shape}"] = row
        emit("dryrun", cell=f"{arch}/{shape}", **row)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    t_start = time.perf_counter()

    # float32 products in full float32; bfloat16 products reduce in
    # float32 (no reduced-precision split-K), for the phase 11 comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bw, flops, peaks = card_peaks(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels = ["bm25_blockmax", "interval_join", "gqa_decode",
               "embedding_bag", "embedding_bag_backward"]
    built = build.build(kernels, verbose=True)
    for k in kernels:
        build.load(k)
    emit("device", card=smi, kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, peaks=peaks,
         matmul={"allow_tf32": False,
                 "allow_bf16_reduced_precision_reduction": False},
         build_s=time.perf_counter() - t0,
         ptxas={k: ptxas_summary(v["log"]) for k, v in built.items()})
    if "gqa_decode" in built:
        lines = ptxas_summary(built["gqa_decode"]["log"])
        check(len(lines) >= 34 and all(" 0 bytes spill stores" in line
                                       for line in lines.values()),
              f"a gqa_decode instantiation spills: {lines}")
    for k in ("bm25_blockmax", "embedding_bag", "embedding_bag_backward"):
        if k in built:
            lines = ptxas_summary(built[k]["log"])
            check(all(" 0 bytes spill stores" in line
                      for line in lines.values()),
                  f"a {k} instantiation spills: {lines}")
    # phase dist (d), the production dry run on the card's fakes, runs in
    # a subprocess on its own host core from here on (its five cells take
    # 150 s there); phase dist collects it
    dist_dry = dist_dryrun_start(dev)
    phase_s = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = time.perf_counter() - t0
        return out

    small_err = timed("kernel_small", phase_kernel_small, dev)
    warren, launches, real_err, queries, served = timed(
        "main_path", phase_main_path, dev, bw, flops)
    rows, deploy_err = timed("deployment", phase_deployment, dev, bw, flops)
    join_mismatches = timed("join_small", phase_join_small, dev)
    join_launches = timed("structured", phase_structured, dev, warren)
    timed("json", phase_json, dev)
    joins = timed("deploy_join", phase_deploy_join, dev, bw, flops)
    del warren, served
    single, single_rows = timed("sharded_single_index", single_index, dev,
                                SHARDED_DOCS, queries)
    timed("sharded", phase_sharded, dev, single, queries, single_rows,
          n_docs=SHARDED_DOCS)
    del single, single_rows
    timed("autopilot", phase_autopilot, dev)
    timed("tiered", phase_tiered, dev)
    decode_err = timed("decode_small", phase_decode_small, dev)
    lm = timed("lm_serve", phase_lm_serve, dev)
    deploy = timed("decode_deploy", phase_decode_deploy, dev, bw, flops)
    timed("moe_small", phase_moe_small, dev)
    moe = timed("moe_serve", phase_moe_serve, dev, bw)
    moe3 = timed("moe_serve_qwen3", phase_moe_serve, dev, bw,
                 cfg=moe3_config(), lens=MOE3_PROMPT_LENS,
                 phase="moe_serve_qwen3", min_splits=2)
    bag_err = timed("bag_small", phase_bag_small, dev)
    recsys = timed("recsys_serve", phase_recsys_serve, dev)
    bags = timed("bag_deploy", phase_bag_deploy, dev, bw, flops)
    back_err = timed("bag_backward_small", phase_bag_backward_small, dev)
    timed("train_lm", phase_train_lm, dev)
    timed("train_small", phase_train_small, dev)
    rec_train = timed("train_recsys", phase_train_recsys, dev)
    backs = timed("bag_backward_deploy", phase_bag_backward_deploy, dev, bw,
                  flops)
    timed("gnn_small", phase_gnn_small, dev)
    timed("gnn_serve", phase_gnn_serve, dev)
    dry = timed("dryrun", phase_dryrun, dev)
    timed("dispatch", dispatch_cost, dev)
    dist = timed("dist", phase_dist, dev, dry=dist_dry)
    emit("done", seconds=time.perf_counter() - t_start, phase_s=phase_s)

    r = rows[10]
    j1 = joins["J1"]
    k32 = deploy["32k"]
    bag = bags["uniform"]
    print(json.dumps({"kernels": [{
        "name": "bm25_blockmax", "route": "cuda",
        "source": "src/repro_torch/csrc/bm25_blockmax.cu",
        "replaces": "src/repro/kernels/bm25_blockmax/kernel.py:42",
        "design": "a warp a doc block, 8 a block; 16-byte loads, all T "
                  "planes in flight before the first add (T templated "
                  "1-16), the upper bound by shuffles",
        "launches": launches,
        "max_abs_err": max(small_err, real_err, deploy_err),
        "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
        "kernel_over_library": r["kernel_over_library"],
        "kernel_device_ms": r["kernel_device_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "shape": [T_DEPLOY, -(-MSMARCO_PASSAGES // BS), BS], "k": 10,
    }, {
        "name": "interval_join", "route": "cuda",
        "source": "src/repro_torch/csrc/interval_join.cu",
        "replaces": "src/repro/kernels/interval_join/kernel.py:57",
        "design": "a tile of 2048 elements of A a block (8 a thread, "
                  "16-byte loads); the tile's window of B bounded by a "
                  "block-wide 256-ary search, copied to shared memory by "
                  "cp.async and searched there when it holds at most the "
                  "budget; the wider tiles listed for the first design's "
                  "kernel, which the last block tail-launches",
        "launches": join_launches,
        "max_abs_err": float(join_mismatches + sum(
            j["mismatches"] for j in joins.values())),
        "ms": j1["kernel_ms"], "kernel_ms": j1["kernel_ms"],
        "plain_ms": j1["plain_ms"], "library_ms": j1["library_ms"],
        "bound_ms": j1["bound_ms"], "bound_by": j1["bound_by"],
        "shape": j1["shape"], "mode": j1["mode"], "tiles": j1["tiles"],
        "operator_ms": j1["operator_ms"],
        **{case: {k: joins[case][k] for k in (
            "shape", "mode", "kernel_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "operator_ms", "tiles")}
           for case in ("J2", "J1_no_order", "J1_off_16")},
    }, {
        "name": "gqa_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/gqa_decode.cu",
        "replaces": "src/repro/kernels/gqa_decode/kernel.py:62",
        "design": "mma: cp.async ring of K/V tiles, mma.sync for q.K and "
                  "P.V (P as bf16 hi + lo: in rows 8-15 of the m16 tile "
                  "at G <= 8, two products a V fragment at 9 <= G <= 16)",
        "launches": lm["calls"][0]["launches"]
        + moe["calls"][0]["launches"] + moe3["calls"][0]["launches"]
        + sum(r["launches"]["gqa_decode"] for r in dry.values())
        + dist["gqa"]["launches"] + dist["decode"]["launches"],
        "launches_by_path": {"lm_serve": lm["calls"][0]["launches"],
                             "moe_serve": moe["calls"][0]["launches"],
                             "moe_serve_qwen3": moe3["calls"][0]["launches"],
                             "dryrun": sum(r["launches"]["gqa_decode"]
                                           for r in dry.values()),
                             "dist_wide_g_d": dist["gqa"]["launches"],
                             "dist_dtensor_decode":
                                 dist["decode"]["launches"]},
        "max_abs_err": max(decode_err, dist["gqa"]["max_abs_err"],
                           *(deploy[c]["max_abs_err"]
                             for c in ("32k", "500k", "32k_g1",
                                       "32k_g16"))),
        "wide_g_d": [c for c in dist["gqa"]["cases"] if "kernel_ms" in c],
        "ms": k32["kernel_ms"], "kernel_ms": k32["kernel_ms"],
        "plain_ms": k32["plain_ms"], "library_ms": k32["library_ms"],
        "bound_ms": k32["bound_ms"], "bound_by": k32["bound_by"],
        "shape": k32["shape"], "g": k32["g"], "dtype": "bfloat16",
        "fma_ms": k32["fma_ms"],
        "500k": {k: deploy["500k"][k] for k in (
            "shape", "kernel_ms", "plain_ms", "fma_ms", "library_ms",
            "bound_ms", "bound_by")},
        **{case: {k: deploy[case][k] for k in (
            "shape", "g", "kernel_ms", "plain_ms", "fma_ms", "library_ms",
            "bound_ms", "bound_by")} for case in ("32k_g1", "32k_g16")},
    }, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:38",
        "design": "rows of more than 16 vectors (uniform, zipf): a warp "
                  "a bag, 32 ids shuffled, 2 rows in flight; narrower "
                  "rows (dlrm): a warp a run of consecutive bags, lanes "
                  "in groups of one row's 16-byte vectors, one bag a "
                  "group, 4 rows a group in flight (4 bags of one, or 4 "
                  "items of a bag), the next step's ids loaded under "
                  "this step's rows",
        "launches": sum(c["launches"] for r in recsys.values()
                        for c in r["cells"].values())
        + sum(r["launches"]["embedding_bag"] for r in dry.values()),
        "dryrun_launches": sum(r["launches"]["embedding_bag"]
                               for r in dry.values()),
        "max_abs_err": max(bag_err, *(r["max_abs_err"]
                                      for r in bags.values())),
        "ms": bag["kernel_ms"], "kernel_ms": bag["kernel_ms"],
        "plain_ms": bag["plain_ms"], "library_ms": bag["library_ms"],
        "kernel_over_library": bag["kernel_over_library"],
        "kernel_device_ms": bag["kernel_device_ms"],
        "bound_ms": bag["bound_ms"], "bound_by": bag["bound_by"],
        "bound_refs_ms": bag["bound_refs_ms"],
        "shape": bag["shape"], "table": bag["table"], "ids": "uniform",
        **{case: {k: bags[case][k] for k in (
            "shape", "table", "kernel_ms", "plain_ms", "library_ms",
            "kernel_over_library", "kernel_device_ms", "bound_ms",
            "bound_by", "bound_refs_ms")} for case in ("zipf", "dlrm")},
        "training_launches": sum(rec_train[a]["launches"] for a in (
            "dlrm-rm2", "two-tower-retrieval")),
    }, {
        "name": "embedding_bag_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag_backward.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:38",
        "note": "the gradient of the forward kernel's function; the JAX "
                "package has no backward kernel (jax.grad scatters through "
                "jnp.take)",
        "design": "a sorted, deterministic segmented reduction, one host "
                  "call: keys (each item's row, or dropped; a bag's "
                  "grad_out row checked once for its zero-weight items), "
                  "an LSD radix sort of (row, item) written here (8 bits a "
                  "pass, stable ranks by __match_any_sync, the first pass "
                  "compacting), runs cut into pieces of at most c items "
                  "added in item order by lane groups of a row's 16-byte "
                  "vectors, a long run's pieces added in piece order; no "
                  "float atomics",
        "c": backs["dlrm"]["c"],
        "launches": sum(rec_train[a]["backward_launches"] for a in (
            "dlrm-rm2", "two-tower-retrieval")),
        "max_abs_err": max(back_err, *(r["max_abs_err"]
                                       for r in backs.values()),
                           backs["two_tower_hist"]["uniform_ids"][
                               "max_abs_err"],
                           *(k["backward_max_abs_err"] for a in (
                               "dlrm-rm2", "two-tower-retrieval")
                             for k in rec_train[a]["lookups"])),
        "ms": backs["dlrm"]["kernel_ms"],
        "kernel_ms": backs["dlrm"]["kernel_ms"],
        "kernel_device_ms": backs["dlrm"]["kernel_device_ms"],
        "parts_ms": backs["dlrm"]["parts_ms"],
        "sort_ms": backs["dlrm"]["sort_ms"],
        "library_sort_ms": backs["dlrm"]["library_sort_ms"],
        "plain_ms": backs["dlrm"]["plain_ms"],
        "library_ms": backs["dlrm"]["library_ms"],
        "bound_ms": backs["dlrm"]["bound_ms"],
        "bound_by": backs["dlrm"]["bound_by"],
        "shape": backs["dlrm"]["shape"], "table": backs["dlrm"]["table"],
        "two_tower_hist": {k: backs["two_tower_hist"][k] for k in (
            "shape", "table", "kernel_ms", "kernel_device_ms", "parts_ms",
            "sort_ms", "library_sort_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "uniform_ids")},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
