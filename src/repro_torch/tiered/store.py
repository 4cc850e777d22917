"""Tiered storage engine: hot dynamic memtable + immutable static runs.

The paper's index is two-faced — a fully dynamic ACID index and an
immutable on-disk static layout — and this module connects them LSM-style:

  writes  →  hot tier: one :class:`~repro_torch.core.index.DynamicIndex` with a
             WAL (``wal.log``) and size-tiered segment auto-merge
  freeze  →  committed hot segments become an immutable *run* directory
             (``static.write_run``), published by a new manifest version,
             and only then detached from the hot tier
  merge   →  overlapping runs fold into one (``static.merge_runs``),
             GC'ing erased records
  reads   →  a :class:`TieredSnapshot` pins a (runs, hot-snapshot) pair;
             per-feature views k-way merge run lists + the hot list in
             sequence order and filter by the union of every tier's
             tombstones — exactly the single-index ``Snapshot`` semantics

The only stop-the-world window is the view swap (a tuple assignment plus
``detach_segments``), measured and reported as compaction pause time.
Crash safety: the run is durable and the manifest swapped *before* the hot
tier forgets the segments, and the WAL is compacted only after that — every
crash point recovers to the latest-good manifest plus the WAL's committed
transactions, with already-frozen segments deduplicated at open.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.annotation import AnnotationList, merge_lists, union_intervals
from repro_torch.core.faults import fault_point
from repro_torch.core.featurizer import Featurizer, JsonFeaturizer
from repro_torch.core.gcl import GCLNode, Phrase, Term
from repro_torch.core.index import (DynamicIndex, Segment, Snapshot, Transaction,
                              _filter_erased, erased_overlaps, tokens_sources,
                              translate_sources)
from repro_torch.core.static import (StaticIndex, merge_runs, run_bytes, slice_run,
                               write_carrier_run, write_run)
from repro_torch.core.tokenizer import Tokenizer, Utf8Tokenizer

from .cache import BlockCache, default_block_cache
from .compaction import CompactionMetrics, LeveledPolicy
from .manifest import Manifest, ManifestStore, RunInfo

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.


class StaticRun:
    """One immutable on-disk run: a StaticIndex plus its manifest record."""

    def __init__(self, index: StaticIndex, info: RunInfo, directory: str):
        self.index = index
        self.info = info
        self.directory = directory

    @staticmethod
    def open(directory: str, info: RunInfo,
             tokenizer: Optional[Tokenizer] = None,
             featurizer: Optional[Featurizer] = None,
             block_cache: Optional[BlockCache] = None) -> "StaticRun":
        return StaticRun(StaticIndex(directory, tokenizer, featurizer,
                                     block_cache=block_cache),
                         info, directory)

    def annotations(self, fval: int) -> AnnotationList:
        return self.index.annotations(fval)

    @property
    def erased(self) -> AnnotationList:
        return self.index.erased

    @property
    def content(self):
        return self.index.content

    def close(self) -> None:
        self.index.close()


def replace_info_nbytes(run: StaticRun) -> RunInfo:
    """A run's info with ``nbytes`` measured from disk — fills the size in
    for runs recorded by pre-leveling manifests (legacy ``nbytes=0``)."""
    from dataclasses import replace
    return replace(run.info, nbytes=run_bytes(run.directory))


def _sort_runs(runs) -> Tuple[StaticRun, ...]:
    """Recency order for the k-way merge: deepest level first (oldest
    data), then ascending sequence within a level, hot tier last — so on
    exact interval ties the newest write wins, exactly the single-index
    semantics, even when leveled compaction leaves interleaved levels."""
    return tuple(sorted(runs, key=lambda r: (-r.info.level, r.info.seq_lo,
                                             r.info.run_id)))


class TieredSnapshot:
    """A consistent read view over N runs + (optionally) a hot snapshot.

    Merge semantics match the single-index :class:`Snapshot` exactly: lists
    are merged in sequence order (runs deepest-level-first then ascending
    sequence — see :func:`_sort_runs` — hot last, so on exact interval ties
    the newest write wins) and filtered by the coalescing union of every
    tier's erased intervals, so tombstones in any tier hide annotations and
    content in every other tier.
    """

    def __init__(self, runs: Tuple[StaticRun, ...], hot: Optional[Snapshot]):
        self.runs = runs
        self.hot = hot
        pieces = [r.erased for r in runs]
        if hot is not None:
            pieces.append(hot.erased)
        self.erased = union_intervals(pieces)
        self._cache: Dict[int, AnnotationList] = {}
        self._cache_lock = threading.Lock()

    def max_seqnum(self) -> int:
        seq = max((r.info.seq_hi for r in self.runs), default=-1)
        if self.hot is not None:
            seq = max(seq, max((s.seqnum for s in self.hot.segments),
                               default=-1))
        return seq

    # -- Idx ------------------------------------------------------------ #
    def annotations(self, fval: int) -> AnnotationList:
        with self._cache_lock:
            got = self._cache.get(fval)
        if got is not None:
            return got
        pieces = [r.annotations(fval) for r in self.runs]
        if self.hot is not None:
            pieces.append(self.hot.annotations(fval))
        merged = _filter_erased(merge_lists(pieces), self.erased)
        with self._cache_lock:
            self._cache[fval] = merged
        return merged

    def hopper(self, fval: int) -> Term:
        return Term(self.annotations(fval))

    # -- Txt ------------------------------------------------------------ #
    def _content_sources(self):
        """Non-empty content stores of every tier, in address order."""
        out = [r.content for r in self.runs if r.content.records()]
        if self.hot is not None:
            out.extend(s.content for s in self.hot.segments
                       if s.content.records())
        out.sort(key=lambda c: c.span()[0])
        return out

    def translate(self, p: int, q: int) -> Optional[str]:
        if erased_overlaps(self.erased, p, q):
            return None
        return translate_sources(self._content_sources(), p, q)

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        if erased_overlaps(self.erased, p, q):
            return None
        return tokens_sources(self._content_sources(), p, q)


# --------------------------------------------------------------------- #
class TieredStore:
    """The tiered engine: hot DynamicIndex + runs + manifest + WAL.

    Directory layout::

        <root>/wal.log              hot-tier transaction log
        <root>/runs/run_<id>/       immutable static runs
        <root>/MANIFEST-<v>.json    versioned manifests (latest-good wins)
    """

    def __init__(self, directory: str,
                 tokenizer: Optional[Tokenizer] = None,
                 featurizer: Optional[Featurizer] = None,
                 auto_merge_threshold: Optional[int] = 8,
                 durable: bool = True,
                 block_cache: Optional[BlockCache] = None):
        self.directory = directory
        self.tokenizer = tokenizer or Utf8Tokenizer()
        self.featurizer = featurizer or JsonFeaturizer()
        self.block_cache = (block_cache if block_cache is not None
                            else default_block_cache())
        os.makedirs(directory, exist_ok=True)
        self.manifests = ManifestStore(directory)
        m = self.manifests.load_latest_good()
        if m is None:
            m = Manifest.initial()
        self.manifests.gc(m)        # torn runs from a crash never resurface
        self._manifest = m
        self._runs: Tuple[StaticRun, ...] = _sort_runs(
            StaticRun.open(self.manifests.run_path(i.name), i,
                           self.tokenizer, self.featurizer,
                           block_cache=self.block_cache)
            for i in m.runs)
        wal = os.path.join(directory, "wal.log") if durable else None
        if wal is not None and os.path.exists(wal):
            hot = DynamicIndex.recover(wal, self.tokenizer, self.featurizer)
        else:
            hot = DynamicIndex(self.tokenizer, self.featurizer, log_path=wal)
        hot.auto_merge_threshold = auto_merge_threshold
        # idempotent crash recovery: a crash after manifest publish but
        # before WAL compaction leaves frozen segments in the WAL too —
        # the manifest wins, the WAL copies are dropped
        if m.frozen_upto >= 0 and hot.detach_segments(m.frozen_upto):
            hot.compact_log()
        with hot._addr_lock:
            hot._next_addr = max(hot._next_addr, m.next_addr)
            hot._next_seq = max(hot._next_seq, m.next_seq)
        self.hot = hot
        self._view_lock = threading.Lock()
        # contention-profiled (lock_wait_ms{lock="tiered_maint"}): freeze
        # vs compact vs demote racing is exactly what /metrics should show
        self._maint_lock = obs.ProfiledLock("tiered_maint",
                                            threading.RLock())
        self.metrics = CompactionMetrics()

    # -- views ------------------------------------------------------------ #
    @property
    def manifest(self) -> Manifest:
        return self._manifest

    @property
    def n_runs(self) -> int:
        return len(self._runs)

    def snapshot(self) -> TieredSnapshot:
        with self._view_lock:
            return TieredSnapshot(self._runs, self.hot.snapshot())

    def warren(self) -> "TieredWarren":
        return TieredWarren(self)

    def runs_info(self) -> dict:
        """The static tier as the admin server's ``/tiered/runs`` serves
        it: manifest position plus one record per live run."""
        with self._view_lock:
            m, runs = self._manifest, self._runs
        levels: Dict[int, int] = {}
        for r in runs:
            levels[r.info.level] = levels.get(r.info.level, 0) + 1
        return {
            "manifest": {"version": m.version,
                         "frozen_upto": m.frozen_upto},
            "n_runs": len(runs),
            "levels": {str(k): v for k, v in sorted(levels.items())},
            "cache": self.block_cache.stats(),
            "runs": [{
                "run_id": r.info.run_id, "name": r.info.name,
                "directory": r.directory,
                "level": r.info.level, "nbytes": r.info.nbytes,
                "seq_lo": r.info.seq_lo, "seq_hi": r.info.seq_hi,
                "addr_lo": r.info.addr_lo, "addr_hi": r.info.addr_hi,
                "n_records": r.info.n_records,
                "n_features": r.info.n_features,
            } for r in runs],
        }

    # -- freeze: hot tier -> new run -------------------------------------- #
    def freeze(self) -> Optional[RunInfo]:
        """Fold every committed hot segment into a new immutable run.

        Readers are never blocked: the run is written and the manifest
        published while the hot tier keeps serving; the swap (run in, hot
        segments out) is a single short critical section against
        ``snapshot()``.  Returns the new run's info, or None when the hot
        tier had nothing committed.
        """
        with self._maint_lock, obs.span("tiered.freeze"):
            hot = self.hot
            hot.merge_segments()       # size-tiered auto-merge, freeze path
            s = hot.max_committed_seq()
            # never advance frozen_upto past a readied-but-uncommitted
            # transaction: its seqnum is below later commits, and a reopen
            # would otherwise discard its recovered segment as "already
            # frozen".  Seqnums are allocated monotonically at ready(), so
            # no new pending transaction can appear at or below ``s``.
            with hot._durable_lock:
                pending_min = min(hot._pending, default=None)
            if pending_min is not None:
                s = min(s, pending_min - 1)
            if s < 0:
                return None
            hot.set_merge_fence(s)     # stabilize the frozen set
            try:
                with hot._publish_lock:
                    segs = tuple(x for x in hot._segments if x.seqnum <= s)
                if not segs:
                    return None
                m = self._manifest
                name = f"run_{m.next_run_id:08d}"
                meta = write_run(segs, self.manifests.run_path(name))
                info = RunInfo.from_meta(m.next_run_id, name, meta)
                with hot._addr_lock:
                    next_addr, next_seq = hot._next_addr, hot._next_seq
                new_m = m.successor(frozen_upto=max(m.frozen_upto, s),
                                    next_run_id=m.next_run_id + 1,
                                    next_addr=next_addr, next_seq=next_seq,
                                    runs=list(m.runs) + [info])
                self.manifests.publish(new_m)   # durable BEFORE hot mutates
                run = StaticRun.open(self.manifests.run_path(name), info,
                                     self.tokenizer, self.featurizer,
                                     block_cache=self.block_cache)
                t0 = time.perf_counter()
                with self._view_lock:
                    self._runs = _sort_runs(self._runs + (run,))
                    hot.detach_segments(s)
                self.metrics.note_freeze(time.perf_counter() - t0)
                self._manifest = new_m
                self._gauge_runs()
            finally:
                hot.set_merge_fence(-1)
            hot.compact_log()          # WAL forgets the frozen segments
            return info

    # -- merge: N runs -> 1 (full, bottom-level) -------------------------- #
    def compact_runs(self, min_runs: int = 2) -> Optional[RunInfo]:
        """Merge every live run into one bottom-level run, GC'ing erased
        records.  No-op below ``min_runs``.  The drain/final-compaction
        path; steady-state maintenance uses :meth:`compact_level`.  Pinned
        snapshots keep serving the victim runs (postings and content reach
        the unlinked file through its still-open mmap)."""
        with self._maint_lock, obs.span("tiered.merge"):
            victims = self._runs
            if len(victims) < max(2, min_runs):
                return None
            out_level = max(v.info.level for v in victims)
            ordered = sorted(victims,
                             key=lambda r: (-r.info.level, r.info.seq_lo,
                                            r.info.run_id))
            m = self._manifest
            name = f"run_{m.next_run_id:08d}"
            meta = merge_runs([v.directory for v in ordered],
                              self.manifests.run_path(name))
            info = RunInfo.from_meta(m.next_run_id, name, meta,
                                     level=out_level)
            new_m = m.successor(next_run_id=m.next_run_id + 1,
                                runs=[info])
            self.manifests.publish(new_m)
            run = StaticRun.open(self.manifests.run_path(name), info,
                                 self.tokenizer, self.featurizer,
                                 block_cache=self.block_cache)
            t0 = time.perf_counter()
            with self._view_lock:
                self._runs = (run,)
            self.metrics.note_merge(time.perf_counter() - t0)
            self._manifest = new_m
            # victims are dropped, not closed: snapshots pinning them keep
            # serving, and each run's fd closes when its last reference
            # dies (StaticIndex.__del__)
            self.manifests.gc(new_m)
            self._gauge_runs()
            return info

    # -- leveled, overlap-aware compaction -------------------------------- #
    def compact_level(self, policy: Optional[LeveledPolicy] = None
                      ) -> Optional[RunInfo]:
        """One leveled compaction step (see :class:`LeveledPolicy`): fold
        the picked victims into one run at the output level.  Erased
        records are GC'd only when the output lands on the bottom level
        (no surviving run is deeper); upper-level merges keep them so the
        reclaim happens once, at the bottom.  Returns the new run's info,
        or None when no level is over target."""
        policy = policy or LeveledPolicy()
        with self._maint_lock, obs.span("tiered.compact_level"):
            runs = self._runs
            infos = [r.info if r.info.nbytes
                     else replace_info_nbytes(r) for r in runs]
            picked = policy.pick(infos)
            if picked is None:
                return None
            victims_info, out_level = picked
            victim_ids = {i.run_id for i in victims_info}
            vmap = {r.info.run_id: r for r in runs}
            victims = [vmap[i.run_id] for i in victims_info]
            survivors = [i for i in self._manifest.runs
                         if i.run_id not in victim_ids]
            gc = not any(i.level > out_level for i in survivors)
            m = self._manifest
            name = f"run_{m.next_run_id:08d}"
            meta = merge_runs([v.directory for v in victims],
                              self.manifests.run_path(name), gc_records=gc)
            info = RunInfo.from_meta(m.next_run_id, name, meta,
                                     level=out_level)
            new_m = m.successor(next_run_id=m.next_run_id + 1,
                                runs=survivors + [info])
            self.manifests.publish(new_m)
            run = StaticRun.open(self.manifests.run_path(name), info,
                                 self.tokenizer, self.featurizer,
                                 block_cache=self.block_cache)
            t0 = time.perf_counter()
            with self._view_lock:
                self._runs = _sort_runs(
                    tuple(r for r in self._runs
                          if r.info.run_id not in victim_ids) + (run,))
            self.metrics.note_merge(time.perf_counter() - t0)
            self._manifest = new_m
            self.manifests.gc(new_m)
            self._gauge_runs()
            return info

    def _gauge_runs(self) -> None:
        """Publish the static tier's size after a run-set swap."""
        reg = obs.registry()
        if not reg.enabled:
            return
        with self._view_lock:
            runs = self._runs
        total = 0
        for r in runs:
            try:
                for fn in os.listdir(r.directory):
                    total += os.path.getsize(os.path.join(r.directory, fn))
            except OSError:
                pass
        reg.gauge("tiered_runs", "live static runs").set(len(runs))
        reg.gauge("tiered_run_bytes",
                  "on-disk bytes across live static runs").set(total)
        by_level: Dict[int, int] = {}
        for r in runs:
            by_level[r.info.level] = by_level.get(r.info.level, 0) + 1
        for level, n in by_level.items():
            reg.gauge("tiered_level_runs",
                      "live static runs per compaction level",
                      level=str(level)).set(n)

    def close(self) -> None:
        for run in self._runs:
            try:
                run.close()
            except OSError:
                pass
        self.hot._log.close()


# --------------------------------------------------------------------- #
class _SnapshotReads:
    """The shared Warren read surface: ``start()`` (subclass-provided) pins
    a :class:`TieredSnapshot` in ``self._snapshot`` and every read
    delegates to it, so TieredWarren and StaticWarren cannot diverge."""

    _snapshot: Optional[TieredSnapshot] = None

    def end(self) -> None:
        self._snapshot = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def featurize(self, feature: str) -> int:
        return self.featurizer.featurize(feature)

    def annotations(self, feature) -> AnnotationList:
        self._require_started()
        fval = feature if isinstance(feature, int) else self.featurize(feature)
        return self._snapshot.annotations(fval)

    def hopper(self, feature) -> Term:
        self._require_started()
        fval = feature if isinstance(feature, int) else self.featurize(feature)
        return self._snapshot.hopper(fval)

    def translate(self, p: int, q: int) -> Optional[str]:
        self._require_started()
        return self._snapshot.translate(p, q)

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        self._require_started()
        return self._snapshot.tokens(p, q)

    def phrase(self, text: str) -> GCLNode:
        self._require_started()
        words = self.tokenizer.split(text)
        terms = [self.hopper(w) for w in words]
        if not terms:
            return Term(AnnotationList.empty())
        return terms[0] if len(terms) == 1 else Phrase(terms)

    def _require_started(self) -> None:
        if self._snapshot is None:
            raise RuntimeError("warren access outside start()/end()")


class TieredWarren(_SnapshotReads):
    """The exact Warren surface over a TieredStore (paper Fig. 3 lifecycle:
    clone/start/end/transaction/ready/commit/abort + Idx/Txt reads), with
    reads k-way merged across the hot tier and every static run."""

    def __init__(self, store: TieredStore):
        self.store = store
        self._snapshot = None
        self._txn: Optional[Transaction] = None

    @property
    def index(self) -> DynamicIndex:
        return self.store.hot

    @property
    def tokenizer(self) -> Tokenizer:
        return self.store.tokenizer

    @property
    def featurizer(self) -> Featurizer:
        return self.store.featurizer

    # -- lifecycle ------------------------------------------------------ #
    def clone(self) -> "TieredWarren":
        return TieredWarren(self.store)

    def start(self) -> None:
        if self._snapshot is not None:
            raise RuntimeError("already started")
        self._snapshot = self.store.snapshot()

    def __exit__(self, *exc) -> bool:
        if self._txn is not None and self._txn._state in ("open", "ready"):
            self._txn.abort()
            self._txn = None
        self.end()
        return False

    # -- transactions (hot tier) ---------------------------------------- #
    def transaction(self) -> None:
        self._require_started()
        if self._txn is not None:
            raise RuntimeError("transaction already active on this warren")
        self._txn = self.store.hot.transaction()

    def append(self, text: str) -> Tuple[int, int]:
        return self._require_txn().append(text)

    def annotate(self, feature, p: int, q: int, v: float = 0.0,
                 v_is_address: bool = False) -> None:
        self._require_txn().annotate(feature, p, q, v,
                                     v_is_address=v_is_address)

    def erase(self, p: int, q: int) -> None:
        self._require_txn().erase(p, q)

    def ready(self) -> None:
        self._require_txn().ready()

    def commit(self):
        txn = self._require_txn()
        txn.commit()
        self._txn = None
        return txn.remap

    def abort(self) -> None:
        self._require_txn().abort()
        self._txn = None

    def _require_txn(self) -> Transaction:
        if self._txn is None:
            raise RuntimeError("no active transaction")
        return self._txn


# --------------------------------------------------------------------- #
# Cold demotion: a whole DynamicIndex <-> a static run set + manifest.
# --------------------------------------------------------------------- #
def _demote_index_impl(index: DynamicIndex, directory: str) -> Manifest:
    """Freeze an entire DynamicIndex into a static run set + manifest
    (the cold form of a ShardedWarren replica group).  Safe to re-demote
    into the same directory: versions increase, old runs are GC'd.

    Emits ``tiered_demote_total`` and a ``tiered.demote`` span — the
    demotion half of the lifecycle signal pair the autopilot's cold
    policy acts through (``tiered_promote_total`` is the other half)."""
    reg = obs.registry()
    if reg.enabled:
        reg.counter("tiered_demote_total",
                    "groups frozen to static run sets").inc()
    with obs.span("tiered.demote", directory=directory):
        return _demote_index(index, directory)


demote_index = _demote_index_impl   # see the note on ``_impl`` names


def _demote_index(index: DynamicIndex, directory: str) -> Manifest:
    ms = ManifestStore(directory)
    prev = ms.load_latest_good() or Manifest.initial()
    with index._durable_lock:
        if index._pending:
            raise RuntimeError(
                "demote_index with in-flight (readied) transactions — "
                "commit or abort them first")
    with index._publish_lock:
        segs = index._segments
    with index._addr_lock:
        next_addr, next_seq = index._next_addr, index._next_seq
    runs: List[RunInfo] = []
    next_run_id = prev.next_run_id
    if segs:
        name = f"run_{next_run_id:08d}"
        meta = write_run(segs, ms.run_path(name))
        runs.append(RunInfo.from_meta(next_run_id, name, meta))
        next_run_id += 1
    m = prev.successor(frozen_upto=max(prev.frozen_upto, next_seq - 1),
                       next_run_id=next_run_id,
                       next_addr=next_addr, next_seq=next_seq, runs=runs)
    ms.publish(m)
    ms.gc(m)
    return m


def _resurrect_index_impl(directory: str, tokenizer: Optional[Tokenizer] = None,
                    featurizer: Optional[Featurizer] = None,
                    n: int = 1) -> List[DynamicIndex]:
    """Rebuild ``n`` lockstep DynamicIndex replicas from a demoted run set,
    streaming each run back through the durable ``Segment.to_record`` form
    so every replica owns its state.  Emits ``tiered_promote_total`` —
    the promotion half of the demotion lifecycle signal pair."""
    reg = obs.registry()
    if reg.enabled:
        reg.counter("tiered_promote_total",
                    "groups rebuilt hot from static run sets").inc()
    ms = ManifestStore(directory)
    m = ms.load_latest_good()
    if m is None:
        raise FileNotFoundError(f"no manifest in {directory}")
    records = []
    # deepest level first, then ascending sequence — recency order, so
    # resurrected segments keep last-wins semantics on exact ties
    for info in sorted(m.runs, key=lambda i: (-i.level, i.seq_lo, i.run_id)):
        si = StaticIndex(ms.run_path(info.name), tokenizer, featurizer)
        records.append(si.to_segment().to_record())
        si.close()
    out = []
    for _ in range(max(1, n)):
        idx = DynamicIndex(tokenizer, featurizer, log_path=None)
        idx._segments = tuple(Segment.from_record(r) for r in records)
        idx._version = 1
        idx._next_addr = m.next_addr
        idx._next_seq = m.next_seq
        out.append(idx)
    return out


resurrect_index = _resurrect_index_impl   # see the note on ``_impl`` names


def _merge_demoted_impl(dst_dir: str, src_dir: str) -> Manifest:
    """Ship one demoted group's runs into another by *manifest*: copy the
    source's immutable run directories file-level into the destination's
    run set (fresh run ids, no record decoding) and publish a successor
    manifest covering both — the cold half of live shard rebalancing.

    Crash safety follows the manifest invariants: runs are copied before
    the successor is published, so a crash mid-copy leaves orphan run
    directories that the next open garbage-collects, and the destination
    keeps recovering to its previous latest-good manifest.  The source
    directory is left untouched (the caller retires the group and may
    delete it once nothing pins its manifest).  Sequence ranges of the two
    groups may overlap; that is safe — their address ranges are disjoint,
    so exact-interval conflicts between the run sets are impossible, and
    allocation floors take the pairwise max.
    """
    import shutil
    from dataclasses import replace as _replace

    dms, sms = ManifestStore(dst_dir), ManifestStore(src_dir)
    dm = dms.load_latest_good()
    sm = sms.load_latest_good()
    if dm is None or sm is None:
        raise FileNotFoundError("merge_demoted needs a manifest on both "
                                f"sides ({dst_dir!r}, {src_dir!r})")
    runs = list(dm.runs)
    next_id = dm.next_run_id
    # idempotent retry: a crashed earlier attempt may have already
    # published some of the source's runs into the destination manifest
    already = {(r.seq_lo, r.seq_hi, r.addr_lo, r.addr_hi, r.n_records,
                r.n_features) for r in dm.runs}
    for info in sm.runs:
        if (info.seq_lo, info.seq_hi, info.addr_lo, info.addr_hi,
                info.n_records, info.n_features) in already:
            continue
        name = f"run_{next_id:08d}"
        target = dms.run_path(name)
        if os.path.exists(target):
            # orphan from a crashed earlier attempt (copied but never
            # published, so next_run_id never advanced): replace it, don't
            # collide — retries must succeed without manual cleanup
            shutil.rmtree(target)
        shutil.copytree(sms.run_path(info.name), target)
        runs.append(_replace(info, run_id=next_id, name=name))
        next_id += 1
    new = dm.successor(frozen_upto=max(dm.frozen_upto, sm.frozen_upto),
                       next_run_id=next_id,
                       next_addr=max(dm.next_addr, sm.next_addr),
                       next_seq=max(dm.next_seq, sm.next_seq),
                       runs=runs)
    dms.publish(new)
    dms.gc(new)     # any remaining orphans from crashed attempts
    return new


merge_demoted = _merge_demoted_impl   # see the note on ``_impl`` names


_SPLIT_CEILING = 1 << 62     # default upper fence for the moved window


def _split_demoted_impl(src_dir: str, keep_dir: str, moved_dir: str,
                  lo: int, hi: int = _SPLIT_CEILING,
                  keep_next_addr: Optional[int] = None,
                  moved_next_addr: Optional[int] = None,
                  tokenizer: Optional[Tokenizer] = None,
                  featurizer: Optional[Featurizer] = None
                  ) -> Tuple[Manifest, Manifest]:
    """Split one demoted run set at the address window ``[lo, hi)`` into
    two fresh run sets — **without promoting or decoding** the cold group.
    ``moved_dir`` receives the window; ``keep_dir`` its complement (a
    group may own several address ranges, so the keep side is not
    contiguous).

    Every run wholly on one side is copied file-level; a run straddling
    the window is cut by :func:`~repro_torch.core.static.slice_run` (postings
    masked by start address, content shipped as raw footer-index extents,
    no decompression).  Both sides receive the source's *full* tombstone
    union — a tombstone recorded in a keep-side run may cover moved-side
    addresses and vice versa — via the sliced runs' erased override plus
    an erased-carrier run for any side that only got whole-run copies.

    Crash safety: the source directory is never touched; both sides are
    built fresh and published (keep side first); ``split.shipped`` fires
    after both are durable.  A crash mid-build leaves the source
    latest-good and partial side directories for the caller to discard.
    Allocation floors: each side's manifest records the floor the caller
    assigns (``*_next_addr``, default the source's own floor — safe,
    allocation is monotone, but the routing layer should hand the side
    that lost the cursor a fresh stripe base).
    """
    from dataclasses import replace as _replace

    sms = ManifestStore(src_dir)
    sm = sms.load_latest_good()
    if sm is None:
        raise FileNotFoundError(f"no manifest in {src_dir}")
    erased_pieces = []
    for info in sm.runs:
        si = StaticIndex(sms.run_path(info.name), tokenizer, featurizer)
        erased_pieces.append(si.erased)
        si.close()
    erased = union_intervals(erased_pieces)

    def build_side(directory: str, moved_side: bool,
                   next_addr: int) -> Manifest:
        import shutil
        ms = ManifestStore(directory)
        runs: List[RunInfo] = []
        next_id = 0
        carried_erased = False
        for info in sm.runs:
            inside = lo <= info.addr_lo and info.addr_hi < hi
            outside = info.addr_hi < lo or info.addr_lo >= hi
            name = f"run_{next_id:08d}"
            target = ms.run_path(name)
            if os.path.exists(target):       # leftover of a crashed build
                shutil.rmtree(target)
            if inside if moved_side else outside:
                # wholly on this side: raw file-level copy, no slicing
                shutil.copytree(sms.run_path(info.name), target)
                runs.append(_replace(info, run_id=next_id, name=name))
                next_id += 1
            elif outside if moved_side else inside:
                continue                     # wholly on the other side
            else:
                meta = slice_run(sms.run_path(info.name), target, lo, hi,
                                 erased_override=erased,
                                 invert=not moved_side)
                if meta is None:
                    continue
                runs.append(RunInfo.from_meta(next_id, name, meta,
                                              level=info.level))
                carried_erased = True
                next_id += 1
        if not carried_erased and len(erased):
            # whole-run copies only: ship the tombstone union separately
            name = f"run_{next_id:08d}"
            meta = write_carrier_run(ms.run_path(name), erased)
            runs.append(RunInfo.from_meta(next_id, name, meta))
            next_id += 1
        m = Manifest.initial().successor(
            frozen_upto=sm.frozen_upto, next_run_id=next_id,
            next_addr=next_addr, next_seq=sm.next_seq, runs=runs)
        ms.publish(m)
        ms.gc(m)
        return m

    keep_m = build_side(keep_dir, False,
                        keep_next_addr if keep_next_addr is not None
                        else sm.next_addr)
    moved_m = build_side(moved_dir, True,
                         moved_next_addr if moved_next_addr is not None
                         else sm.next_addr)
    fault_point("split.shipped")
    return keep_m, moved_m


split_demoted = _split_demoted_impl   # see the note on ``_impl`` names


class StaticWarren(_SnapshotReads):
    """Read-only Warren surface over a demoted run set (no hot tier).

    Clones share the loaded runs; ``start`` pins a runs-only
    :class:`TieredSnapshot`.  Writes are structurally impossible — the
    owner (a shard router) promotes the group back to dynamic first.
    """

    def __init__(self, directory: str,
                 tokenizer: Optional[Tokenizer] = None,
                 featurizer: Optional[Featurizer] = None,
                 _shared: Optional[tuple] = None,
                 block_cache: Optional[BlockCache] = None):
        self.directory = directory
        self.tokenizer = tokenizer or Utf8Tokenizer()
        self.featurizer = featurizer or JsonFeaturizer()
        if _shared is not None:
            self.manifest, self._runs = _shared
        else:
            cache = (block_cache if block_cache is not None
                     else default_block_cache())
            ms = ManifestStore(directory)
            m = ms.load_latest_good()
            if m is None:
                raise FileNotFoundError(f"no manifest in {directory}")
            self.manifest = m
            self._runs = _sort_runs(
                StaticRun.open(ms.run_path(i.name), i, self.tokenizer,
                               self.featurizer, block_cache=cache)
                for i in m.runs)
        self._snapshot = None

    @property
    def index(self) -> "StaticWarren":
        return self

    def max_seqnum(self) -> int:
        return max((r.info.seq_hi for r in self._runs), default=-1)

    def clone(self) -> "StaticWarren":
        return StaticWarren(self.directory, self.tokenizer, self.featurizer,
                            _shared=(self.manifest, self._runs))

    def start(self) -> None:
        if self._snapshot is not None:
            raise RuntimeError("already started")
        self._snapshot = TieredSnapshot(self._runs, None)

    def close(self) -> None:
        for r in self._runs:
            try:
                r.close()
            except OSError:
                pass
