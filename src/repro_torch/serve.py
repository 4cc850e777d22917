"""Serving loops: the first-stage BM25 retriever with dynamic request
batching, and greedy LM decode with continuous batching.

RetrievalServer serves ranked retrieval straight from an annotative index
(the paper's workload).  Each micro-batch runs in three steps:

  scatter  look up each query term's posting list and compute its BM25
           impacts on the host (numpy, float64), capped per term by impact;
  score    pack them into padded ``(doc_idx, impacts, qmask)`` arrays, copy
           them to the device and run one dense ``bm25_topk`` there;
  merge    map document indices back to addresses, dropping zero scores.

A ``ShardedWarren`` (an object with ``map_groups``) is served natively:
one fan-out per shard group gathers its stats and term lists, the BM25
statistics and the posting cap are taken over the whole collection, each
group's block is packed into page-locked memory and scored by its own
device top-k without a host sync between groups, and a host merge keyed by
``(-score, address)`` gives the global top-k.

The server runs on the card unless the caller passes ``device="cpu"``.

LMServer decodes a batch of prompts greedily through the transformer's
``decode_step`` (whose attention is the ``gqa_decode`` kernel), also on the
card unless asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import collection_stats, ranking
from repro_torch.core.vectorized import bm25_topk
from repro_torch.device import resolve_device
from repro_torch.dist.parallel import ScatterTimings
from repro_torch.models import transformer as T


@dataclasses.dataclass
class BatcherConfig:
    max_batch: int = 16
    max_wait_ms: float = 2.0


class _BatchFailure:
    """A handler exception, boxed so waiters can tell it from a result."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Handle:
    """One request's completion slot; ``get`` re-raises handler failures."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)

    def _put(self, item) -> None:
        self._q.put(item)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        res = self._q.get(block, timeout)
        if isinstance(res, _BatchFailure):
            raise res.exc
        return res


class MicroBatcher:
    """Dynamic batching: collect up to max_batch requests or max_wait_ms.

    A handler exception fails only the requests of that batch — it is
    boxed, delivered to each waiter's handle (re-raised from ``get``), and
    the batching loop keeps serving later requests.
    """

    def __init__(self, handler: Callable[[List[Any]], List[Any]],
                 cfg: BatcherConfig):
        self.handler = handler
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # orders submit vs close-drain; contention-profiled
        # (lock_wait_ms{lock="microbatcher"})
        self._close_lock = obs.ProfiledLock("microbatcher")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request) -> _Handle:
        done = _Handle()
        with self._close_lock:
            if self._stop.is_set():
                done._put(_BatchFailure(RuntimeError("MicroBatcher closed")))
                return done
            self._q.put((request, done))
        return done

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.cfg.max_wait_ms / 1e3
            while len(batch) < self.cfg.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            reg = obs.registry()
            if reg.enabled:
                reg.gauge("serve_queue_depth",
                          "requests still queued when a batch launches"
                          ).set(self._q.qsize())
                reg.histogram("serve_batch_size",
                              "requests coalesced per micro-batch",
                              lo=0.5, hi=1e4, per_decade=40
                              ).observe(len(batch))
            try:
                with obs.span("serve.batch", size=len(batch)):
                    results = self.handler([r for r, _ in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"handler returned {len(results)} results for a "
                        f"batch of {len(batch)}")
            except Exception as e:
                failure = _BatchFailure(e)
                for _, done in batch:
                    done._put(failure)
                continue
            for (_, done), res in zip(batch, results):
                done._put(res)

    def close(self):
        """Stop the loop and promptly fail queued waiters — nobody blocks
        out their full timeout on a closed batcher."""
        with self._close_lock:    # no submit can slip in after the drain
            self._stop.set()
        self._thread.join(timeout=1.0)
        failure = _BatchFailure(RuntimeError("MicroBatcher closed"))
        while True:
            try:
                _, done = self._q.get_nowait()
            except queue.Empty:
                break
            done._put(failure)


class RetrievalServer:
    """BM25 top-k over an annotative index with batched device scoring.

    Works over any object with the Warren read surface — a single
    ``Warren``, a ``ShardedWarren`` (with demoted cold groups), or a
    ``TieredWarren``, whose ``annotations`` already k-way merge the hot
    memtable with every on-disk static run.  After commits, tier freezes,
    or shard demotions change the collection, call :meth:`refresh_stats`.

    A ``ShardedWarren`` is served natively (scatter once per group, score
    per group, merge globally) unless ``sharded_native=False``.
    ``timings`` holds the per-batch scatter/score/merge breakdown.
    ``device=None`` scores on the card and raises when there is none;
    ``device="cpu"`` scores on the host with the same arithmetic, so both
    give the same bits.
    """

    def __init__(self, warren, k: int = 10, batcher: BatcherConfig = None,
                 max_terms: int = 8, max_postings: int = 4096,
                 sharded_native: bool = True, device=None):
        self.device = resolve_device(device)
        self.warren = warren
        self.k = k
        self.max_terms = max_terms
        self.max_postings = max_postings
        self._sharded = sharded_native and hasattr(warren, "map_groups")
        self.timings = ScatterTimings(site="server")
        # device shape buckets already scored: the counter that tells
        # shape-bucket churn from steady-state serving
        self._seen_shapes: set = set()
        if self._sharded:
            self.stats = None    # the native path re-scatters per batch
        else:
            with warren:
                self.stats = collection_stats(warren)
        self.batcher = MicroBatcher(self._handle, batcher or BatcherConfig())

    def refresh_stats(self) -> None:
        """Re-derive collection statistics from a fresh snapshot; queries
        already in flight finish against the stats they started with.
        Reads through a clone so it never collides with the batcher
        thread's start()/end() bracket on the serving warren.  The native
        sharded path scatters fresh stats every batch, so there is
        nothing to refresh."""
        if self._sharded:
            return
        w = self.warren.clone()
        with w:
            self.stats = collection_stats(w)

    def timing_summary(self) -> str:
        return self.timings.summary()

    def query(self, text: str, timeout: float = 10.0):
        return self.batcher.submit(text).get(timeout=timeout)

    def _handle(self, queries: List[str]) -> List[List[Tuple[int, float]]]:
        # coalesce duplicate requests: a batch scores each distinct query
        # once, every waiter gets (a copy of) the shared result row
        uniq = list(dict.fromkeys(queries))
        rows = (self._handle_sharded(uniq) if self._sharded
                else self._handle_single(uniq))
        if len(uniq) == len(queries):
            return rows
        # timings count served requests, so per-query figures stay
        # comparable with wall-clock ms/query over the same stream
        self.timings.add(queries=len(queries) - len(uniq))
        by_query = dict(zip(uniq, rows))
        return [list(by_query[q]) for q in queries]

    def _query_terms(self, queries: List[str]) -> List[List[str]]:
        return [list(dict.fromkeys(ranking.ranking_tokens(q)))[:self.max_terms]
                for q in queries]

    @staticmethod
    def _cap_by_impact(di: np.ndarray, imp: np.ndarray,
                       limit: int) -> Tuple[np.ndarray, np.ndarray]:
        """Keep the top-``limit`` postings by impact (stable, so equal
        impacts keep address order) — truncating by document order would
        silently drop high-impact documents past the cap."""
        if len(di) <= limit:
            return di, imp
        keep = np.argsort(-imp, kind="stable")[:limit]
        return di[keep], imp[keep]

    def _pad_sizes(self, qn: int, nterms: int,
                   longest: int) -> Tuple[int, int, int]:
        """Stable device shapes: the batch and term dims bucket to powers
        of two and the postings dim to a multiple of 256, so the device
        sees a bounded set of shapes instead of one per (batch size, term
        count, longest list) — and short queries don't pay for
        ``max_terms`` worth of padded scatter work."""
        qp = max(1 << max(qn - 1, 0).bit_length(), 1)
        tp = min(self.max_terms, max(1 << max(nterms - 1, 0).bit_length(), 1))
        l = max(256, -(-longest // 256) * 256)
        return qp, tp, min(self.max_postings, l)

    def _acc_pad(self, n_docs: int) -> int:
        """Accumulator-size bucket: a power of two ≥ max(n_docs, k), so a
        commit changing the live document count keeps the device shape.
        Padded slots never receive impacts, score 0, and are filtered by
        the ``s > 0`` result guard."""
        return 1 << max(max(n_docs, self.k) - 1, 0).bit_length()

    def _note_shapes(self, qp: int, tp: int, l: int, nb: int) -> None:
        """Count first sightings of a device shape bucket."""
        key = (qp, tp, l, nb, self.k)
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            reg = obs.registry()
            if reg.enabled:
                reg.counter(
                    "serve_jit_recompile_total",
                    "distinct (batch, terms, postings, accumulator) device "
                    "shape buckets scored"
                ).inc()

    def _handle_single(self, queries: List[str]
                       ) -> List[List[Tuple[int, float]]]:
        stats = self.stats      # one coherent stats version per batch
        qn, l_cap = len(queries), self.max_postings
        if stats.n_docs == 0:
            return [[] for _ in queries]
        t0 = time.perf_counter()
        entries: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        with self.warren:
            for qi, terms in enumerate(self._query_terms(queries)):
                for ti, term in enumerate(terms):
                    lst = self.warren.annotations(
                        ranking.TF_PREFIX + ranking.porter_stem(term))
                    if not len(lst):
                        continue
                    idf = ranking._bm25_idf(stats.n_docs, len(lst))
                    di, imp = ranking._impacts(lst, stats, idf,
                                               k1=0.9, b=0.4)
                    di, imp = self._cap_by_impact(di, imp, l_cap)
                    entries.append((qi, ti, di, imp))
        t_scatter = time.perf_counter() - t0
        t0 = time.perf_counter()
        qp, tp, l = self._pad_sizes(
            qn, max((e[1] + 1 for e in entries), default=1),
            max((len(e[2]) for e in entries), default=1))
        nb = self._acc_pad(stats.n_docs)
        self._note_shapes(qp, tp, l, nb)
        with obs.span("device_score"):
            with obs.phase_timer("bm25_topk", "gather"):
                doc_idx = np.full((qp, tp, l), nb, np.int32)
                impacts = np.zeros((qp, tp, l), np.float32)
                qmask = np.zeros((qp, tp), np.float32)
                for qi, ti, di, imp in entries:
                    doc_idx[qi, ti, :len(di)] = di
                    impacts[qi, ti, :len(di)] = imp
                    qmask[qi, ti] = 1.0
            # launched on this thread's current stream; .cpu() is the sync
            with obs.phase_timer("bm25_topk", "compute"):
                dev = self.device
                scores, ids = bm25_topk(torch.from_numpy(doc_idx).to(dev),
                                        torch.from_numpy(impacts).to(dev),
                                        torch.from_numpy(qmask).to(dev),
                                        n_docs=nb, k=self.k)
                scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        t_score = time.perf_counter() - t0
        t0 = time.perf_counter()
        with obs.span("merge"):
            out = []
            for qi in range(qn):
                res = [(int(stats.doc_starts[d]), float(s))
                       for d, s in zip(ids[qi], scores[qi]) if s > 0]
                out.append(res)
        t_merge = time.perf_counter() - t0
        self.timings.add(scatter=t_scatter, score=t_score, merge=t_merge,
                         queries=qn)
        return out

    # -- native ShardedWarren path ----------------------------------------- #
    def _staging(self, shape: Tuple[int, ...], dtype: torch.dtype,
                 fill) -> torch.Tensor:
        """A host block to pack into: page-locked when scoring on the card,
        so its copy there can run without blocking the host.  A fresh one
        per group and batch: the caching host allocator hands the memory
        out again only after the copy that reads it has run."""
        t = torch.empty(shape, dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        t.fill_(fill)
        return t

    def _collect(self, pending: List[Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]]]
                 ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """Every group's (scores, ids) on the host, behind ONE sync: the
        results are stacked on the card and copied to page-locked memory
        without blocking, then the stream is synchronized once."""
        live = [p for p in pending if p is not None]
        if not live:
            return [None] * len(pending)
        scores = torch.stack([p[0] for p in live])
        ids = torch.stack([p[1] for p in live])
        if self.device.type == "cuda":
            hs = torch.empty(scores.shape, dtype=scores.dtype,
                             pin_memory=True)
            hi = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            hs.copy_(scores, non_blocking=True)
            hi.copy_(ids, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            scores, ids = hs, hi
        sc, di = scores.numpy(), ids.numpy()
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        j = 0
        for p in pending:
            if p is None:
                out.append(None)
            else:
                out.append((sc[j], di[j]))
                j += 1
        return out

    def _handle_sharded(self, queries: List[str]
                        ) -> List[List[Tuple[int, float]]]:
        qn, l, k = len(queries), self.max_postings, self.k
        qterms = self._query_terms(queries)
        # stem every query term once; pack_group indexes these features
        qfeatures = [[ranking.TF_PREFIX + ranking.porter_stem(term)
                      for term in terms] for terms in qterms]
        stems = list(dict.fromkeys(f for row in qfeatures for f in row))
        # scatter: ONE fan-out per group for the whole micro-batch — every
        # group returns its stats and its slice of every term list (the
        # fan-out follows the session's pinned routing table, so the group
        # count comes from the gather, not from the live warren).  The
        # closures only read the host index; every torch call stays on
        # this (the batcher's) thread.
        t0 = time.perf_counter()
        with self.warren:
            gathered = self.warren.map_groups(
                lambda w: (ranking.collection_stats(w),
                           [w.annotations(f) for f in stems]))
        t_scatter = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_groups = len(gathered)
        per = [s for s, _ in gathered]
        lists = [lst for _, lst in gathered]
        n_docs = sum(s.n_docs for s in per)
        if n_docs == 0:
            self.timings.add(scatter=t_scatter, queries=qn)
            return [[] for _ in queries]
        # global stats, computed exactly as collection_stats would over the
        # merged surface (avgdl is order-free; ties merge by address below)
        avgdl = float(np.concatenate([s.doc_lens for s in per]).mean())
        # per stem: per-group (doc_idx, impact) with GLOBAL df/avgdl, then
        # the posting cap applied to the *global* list so the kept postings
        # are exactly the single-index path's
        term_group: Dict[str, Optional[List[Tuple[np.ndarray, np.ndarray]]]] \
            = {}
        empty = (np.zeros(0, np.int64), np.zeros(0))
        for si, f in enumerate(stems):
            df = sum(len(lists[g][si]) for g in range(n_groups))
            if df == 0:
                term_group[f] = None
                continue
            idf = ranking._bm25_idf(n_docs, df)
            per_g = []
            for g in range(n_groups):
                lst, stats = lists[g][si], per[g]
                if len(lst) == 0 or stats.n_docs == 0:
                    per_g.append(empty)
                    continue
                per_g.append(ranking._impacts_with_avgdl(lst, stats, idf,
                                                         avgdl))
            total = sum(len(di) for di, _ in per_g)
            if total > l:
                cat = np.concatenate([imp for _, imp in per_g])
                keep = np.zeros(total, bool)
                keep[np.argsort(-cat, kind="stable")[:l]] = True
                capped, off = [], 0
                for di, imp in per_g:
                    m = keep[off:off + len(di)]
                    off += len(di)
                    capped.append((di[m], imp[m]))
                per_g = capped
            term_group[f] = per_g

        def pack_group(g: int):
            """This group's (doc_idx, impacts, qmask) host block, or None
            when the group has no documents or no postings for the batch."""
            ng = per[g].n_docs
            if ng == 0:
                return None
            longest = max((len(per_g[g][0]) for per_g in term_group.values()
                           if per_g is not None), default=0)
            if longest == 0:    # nothing scored here: all-zero rows anyway
                return None
            qp, tp, lg = self._pad_sizes(
                qn, max((len(row) for row in qfeatures), default=1), longest)
            nb = self._acc_pad(ng)
            self._note_shapes(qp, tp, lg, nb)
            blk = (self._staging((qp, tp, lg), torch.int32, nb),
                   self._staging((qp, tp, lg), torch.float32, 0.0),
                   self._staging((qp, tp), torch.float32, 0.0))
            doc_idx, impacts, qmask = (t.numpy() for t in blk)
            for qi, row in enumerate(qfeatures):
                for ti, f in enumerate(row):
                    per_g = term_group[f]
                    if per_g is None:
                        continue
                    qmask[qi, ti] = 1.0
                    di, imp = per_g[g]
                    if len(di):
                        doc_idx[qi, ti, :len(di)] = di
                        impacts[qi, ti, :len(di)] = imp
            return blk, nb

        # pipelined scoring: the copies from page-locked memory and the
        # top-k launch without waiting, so group g's top-k runs on the card
        # while group g+1's block is packed; _collect syncs once for all
        dev = self.device
        with obs.span("device_score"):
            pending, staged = [], []
            for g in range(n_groups):
                with obs.phase_timer("bm25_topk", "gather"):
                    packed = pack_group(g)
                if packed is None:
                    pending.append(None)
                    continue
                blk, nb = packed
                staged.append(blk)   # held until the sync below
                doc_idx, impacts, qmask = (t.to(dev, non_blocking=True)
                                           for t in blk)
                pending.append(bm25_topk(doc_idx, impacts, qmask,
                                         n_docs=nb, k=k))
            with obs.phase_timer("bm25_topk", "compute"):
                group_res = self._collect(pending)
            del staged
        t_score = time.perf_counter() - t0
        # gather: global k-way merge; per-group lists come out of top_k
        # sorted by (-score, doc index) = (-score, address) within a group,
        # and the composite key merges on the document's ADDRESS, which is
        # the single-index tie order no matter how rebalancing has
        # interleaved group address ranges
        t0 = time.perf_counter()
        with obs.span("merge"):
            out = []
            for qi in range(qn):
                runs = []
                for g, res in enumerate(group_res):
                    if res is None:
                        continue
                    sc, ids = res
                    runs.append([(-float(s), int(per[g].doc_starts[int(d)]))
                                 for s, d in zip(sc[qi], ids[qi]) if s > 0])
                merged = heapq.merge(*runs)   # key: (-score, address)
                row = [(addr, -neg_s)
                       for neg_s, addr in itertools.islice(merged, k)]
                out.append(row)
        t_merge = time.perf_counter() - t0
        self.timings.add(scatter=t_scatter, score=t_score, merge=t_merge,
                         queries=qn)
        return out

    def close(self):
        self.batcher.close()


class LMServer:
    """Continuous-batching greedy decode over the transformer decode path.

    ``model`` is a :class:`~repro_torch.models.transformer.Transformer` on
    ``device`` (``None`` means the card).  ``max_slots`` sequences decode
    together against one KV cache of ``max_len`` positions.
    """

    def __init__(self, model: T.Transformer, max_slots: int = 8,
                 max_len: int = 128, device=None):
        self.device = resolve_device(device)
        mdev = model.device
        if mdev.type != self.device.type or (
                self.device.index is not None
                and mdev.index != self.device.index):
            raise ValueError(f"the model is on {mdev}, the server on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache: Optional[Dict[str, torch.Tensor]] = None

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot: tokens [max_slots] → logits
        [max_slots, V]; the cache advances in place."""
        logits, self.cache = T.decode_step(self.model, self.cache, tokens)
        return logits

    def generate(self, prompts: List[List[int]], max_new: int = 16
                 ) -> List[List[int]]:
        """Greedy-decode a batch of prompts (token-id lists).

        The prompts prefill by stepping their tokens one at a time; slots
        beyond ``len(prompts)`` step token 0.  Ties in the argmax go to the
        lowest token id, as in JAX.
        """
        if len(prompts) > self.max_slots:
            raise ValueError(f"{len(prompts)} prompts for {self.max_slots} "
                             f"slots")
        # a fresh KV cache per call: decoding against a previous call's
        # cache would attend to its keys/values and resume at its length
        # (the old one goes first, so two are never held)
        self.cache = None
        self.cache = T.init_cache(self.cfg, self.max_slots, self.max_len,
                                  self.device)
        outs: List[List[int]] = [[] for _ in prompts]
        tokens = np.zeros((self.max_slots,), np.int64)
        max_prompt = max(len(p) for p in prompts)
        for i in range(max_prompt + max_new):
            for s, p in enumerate(prompts):
                if i < len(p):
                    tokens[s] = p[i]
            logits = self.step(torch.tensor(tokens, device=self.device))
            nxt = logits.argmax(-1).cpu().numpy()
            for s, p in enumerate(prompts):
                if i >= len(p) - 1:       # past the prompt: greedy decode
                    outs[s].append(int(nxt[s]))
                    tokens[s] = int(nxt[s])
        return [o[:max_new] for o in outs]
