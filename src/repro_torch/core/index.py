"""The dynamic annotative index: MVCC segments, ACID transactions (paper §5).

Each committed transaction becomes an immutable :class:`Segment` (the paper's
"update Warren") holding the content it appended plus *all* annotations it
added — which may reference addresses appended by earlier transactions (the
defining flexibility of annotative indexing).  A read :class:`Snapshot` is a
sequence-ordered tuple of segments; per-feature views are K-way merges with
the paper's conflict rules (innermost annotation wins; on exact interval
ties, the largest sequence number wins) and erased intervals filtered out.

Transactions follow two-phase commit:

  transaction() → append()/annotate()/erase() in a *local* (negative)
  address space → ready() assigns the permanent base address + seqnum under
  a brief global lock and durably logs the update → commit() logs the commit
  marker and atomically publishes the segment → (abort() leaves a gap).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from .annotation import (AnnotationList, merge_lists, reduce_minimal,
                         union_intervals)
from .featurizer import Featurizer, JsonFeaturizer
from .gcl import Term
from .log import TransactionLog
from .tokenizer import Tokenizer, Utf8Tokenizer
from .txt import AppendRecord, ContentStore

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

ERASE_FEATURE = 0                 # reserved: erased intervals
_LOCAL_BASE = -(1 << 40)          # staging addresses are negative (paper §1)


# --------------------------------------------------------------------- #
class Segment:
    """Immutable committed update."""

    __slots__ = ("seqnum", "base", "length", "content", "postings", "erased")

    def __init__(self, seqnum: int, base: int, length: int,
                 content: ContentStore,
                 postings: Dict[int, AnnotationList],
                 erased: AnnotationList):
        self.seqnum = seqnum
        self.base = base
        self.length = length
        self.content = content
        self.postings = postings
        self.erased = erased

    # -- durable form -------------------------------------------------- #
    def to_record(self) -> dict:
        from . import vbyte
        feats = []
        for fval, lst in self.postings.items():
            feats.append({
                "f": fval,
                "n": len(lst),
                "s": vbyte.encode_gaps(lst.starts),
                "e": vbyte.encode_gaps(lst.ends),
                "v": lst.values.tobytes(),
            })
        appends = [{
            "lo": r.lo, "hi": r.hi, "text": r.text,
            "off": np.asarray(r.offsets, dtype=np.int64).tobytes(),
            "tok": list(r.tokens),
        } for r in self.content.records()]
        return {
            "t": "ready", "seq": self.seqnum, "base": self.base,
            "length": self.length, "appends": appends, "features": feats,
            "er_s": vbyte.encode_gaps(self.erased.starts),
            "er_e": vbyte.encode_gaps(self.erased.ends),
            "er_n": len(self.erased),
        }

    @staticmethod
    def from_record(rec: dict) -> "Segment":
        from . import vbyte
        content = ContentStore()
        for a in rec["appends"]:
            off = np.frombuffer(a["off"], dtype=np.int64).reshape(-1, 2)
            content.add(AppendRecord(a["lo"], a["hi"], a["text"], off,
                                     tuple(a["tok"])))
        postings: Dict[int, AnnotationList] = {}
        for f in rec["features"]:
            n = f["n"]
            postings[f["f"]] = AnnotationList(
                vbyte.decode_gaps(f["s"], n), vbyte.decode_gaps(f["e"], n),
                np.frombuffer(f["v"], dtype=np.float64), _checked=True)
        erased = AnnotationList(
            vbyte.decode_gaps(rec["er_s"], rec["er_n"]),
            vbyte.decode_gaps(rec["er_e"], rec["er_n"]),
            np.zeros(rec["er_n"]), _checked=True)
        return Segment(rec["seq"], rec["base"], rec["length"], content,
                       postings, erased)


def partition_segment(seg: Segment, lo: int, hi: int
                      ) -> Tuple[Optional[Segment], Optional[Segment]]:
    """Split one committed segment at the address window [lo, hi) for shard
    rebalancing: returns ``(inside, outside)``.

    A content record belongs to the side owning its first address (records
    never straddle a rebalance pivot — pivots are document boundaries), and
    an annotation belongs to the side owning its *start* address — the same
    rule cross-shard routing uses, so after a split every annotation still
    lives in exactly one replica group.  Neither side carries erased
    intervals: erasure is a point-set over addresses, and a tombstone may be
    recorded in a segment that lands wholly on the other side, so the caller
    installs the group's full tombstone union separately (an erased-carrier
    segment) on *both* sides.  A side with no content and no postings is
    returned as None.
    """
    in_content, out_content = ContentStore(), ContentStore()
    for r in seg.content.records():
        (in_content if lo <= r.lo < hi else out_content).add(r)
    in_postings: Dict[int, AnnotationList] = {}
    out_postings: Dict[int, AnnotationList] = {}
    for fval, lst in seg.postings.items():
        mask = (lst.starts >= lo) & (lst.starts < hi)
        if mask.all():
            in_postings[fval] = lst
        elif not mask.any():
            out_postings[fval] = lst
        else:
            in_postings[fval] = AnnotationList(
                lst.starts[mask], lst.ends[mask], lst.values[mask],
                _checked=True)
            keep = ~mask
            out_postings[fval] = AnnotationList(
                lst.starts[keep], lst.ends[keep], lst.values[keep],
                _checked=True)

    def _side(content: ContentStore, postings: Dict[int, AnnotationList]
              ) -> Optional[Segment]:
        postings = {f: l for f, l in postings.items() if len(l)}
        recs = content.records()
        if not recs and not postings:
            return None
        if recs:
            base = min(r.lo for r in recs)
            length = max(r.hi for r in recs) - base + 1
        else:
            base, length = seg.base, 0
        return Segment(seg.seqnum, base, length, content, postings,
                       AnnotationList.empty())

    return (_side(in_content, in_postings), _side(out_content, out_postings))


def erased_carrier(seqnum: int, base: int,
                   erased: AnnotationList) -> Segment:
    """A zero-length segment holding only erased intervals — the durable
    form of a replica group's full tombstone union after a rebalance
    partition (see :func:`partition_segment`)."""
    return Segment(seqnum, base, 0, ContentStore(), {}, erased)


def erased_overlaps(erased: AnnotationList, p: int, q: int) -> bool:
    """Does [p, q] intersect any erased interval?"""
    if len(erased) == 0:
        return False
    i = int(np.searchsorted(erased.ends, p, side="left"))
    return i < len(erased) and int(erased.starts[i]) <= q


def translate_sources(sources, p: int, q: int) -> Optional[str]:
    """T(p, q) stitched across address-ordered content stores; None on any
    gap (the shared Txt walk of Snapshot, StaticIndex, and TieredSnapshot —
    erased filtering is the caller's job)."""
    parts = []
    expect = p
    for content in sources:
        lo, hi = content.span()
        if hi < expect or lo > q:
            continue
        if lo > expect:
            return None  # gap
        t = content.translate(expect, min(q, hi))
        if t is None:
            return None
        parts.append(t)
        expect = hi + 1
        if expect > q:
            break
    if expect <= q:
        return None
    return " ".join(parts)


def tokens_sources(sources, p: int, q: int) -> Optional[List[str]]:
    """Token strings over [p, q] across address-ordered content stores."""
    out: List[str] = []
    expect = p
    for content in sources:
        lo, hi = content.span()
        if hi < expect or lo > q:
            continue
        if lo > expect:
            return None
        t = content.tokens(expect, min(q, hi))
        if t is None:
            return None
        out.extend(t)
        expect = hi + 1
        if expect > q:
            break
    return out if expect > q else None


def _filter_erased(lst: AnnotationList, erased: AnnotationList) -> AnnotationList:
    """Drop annotations whose interval intersects any erased interval."""
    if len(lst) == 0 or len(erased) == 0:
        return lst
    # first erased interval with end >= annotation start; intersects if its
    # start <= annotation end.
    idx = np.searchsorted(erased.ends, lst.starts, side="left")
    valid = idx < len(erased)
    hit = np.zeros(len(lst), dtype=bool)
    hit[valid] = erased.starts[idx[valid]] <= lst.ends[valid]
    if not hit.any():
        return lst
    keep = ~hit
    return AnnotationList(lst.starts[keep], lst.ends[keep], lst.values[keep],
                          _checked=True)


class Snapshot:
    """A consistent read view: immutable segment tuple + merged-view caches.

    The cache dict is shared via the owning index and keyed by
    (version, feature), so concurrent snapshots of the same version reuse
    merged lists.
    """

    def __init__(self, version: int, segments: Tuple[Segment, ...],
                 cache: dict, cache_lock: threading.Lock):
        self.version = version
        self.segments = segments
        self._cache = cache
        self._cache_lock = cache_lock
        # erasure is permanent over a point-set of addresses: coalescing
        # union, NOT minimal-interval reduction (a nested erase must never
        # un-hide the rest of its enclosing erased range)
        self.erased = union_intervals([s.erased for s in segments])

    # -- Idx ------------------------------------------------------------ #
    def annotations(self, fval: int) -> AnnotationList:
        key = (self.version, fval)
        with self._cache_lock:
            got = self._cache.get(key)
        if got is not None:
            return got
        pieces = [s.postings[fval] for s in self.segments if fval in s.postings]
        merged = _filter_erased(merge_lists(pieces), self.erased)
        with self._cache_lock:
            self._cache[key] = merged
        return merged

    def hopper(self, fval: int) -> Term:
        """Create a cursor (the paper's Hopper) for a feature value."""
        return Term(self.annotations(fval))

    # -- Txt ------------------------------------------------------------ #
    def _sources(self):
        return [s.content for s in self.segments if s.length]

    def translate(self, p: int, q: int) -> Optional[str]:
        if erased_overlaps(self.erased, p, q):
            return None
        return translate_sources(self._sources(), p, q)

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        if erased_overlaps(self.erased, p, q):
            return None
        return tokens_sources(self._sources(), p, q)


# --------------------------------------------------------------------- #
class Transaction:
    """Two-phase-commit update; see module docstring."""

    def __init__(self, index: "DynamicIndex"):
        self._index = index
        self._tokenizer = index.tokenizer
        self._featurizer = index.featurizer
        self._local_next = 0
        self._appends: List[Tuple[int, str, np.ndarray, Tuple[str, ...]]] = []
        self._ann: List[Tuple[int, int, int, float]] = []  # (fval, p, q, v)
        self._addr_valued: List[int] = []  # indices of address-valued annotations
        self._erase: List[Tuple[int, int]] = []
        self._state = "open"
        self._segment: Optional[Segment] = None
        self._base: Optional[int] = None

    def remap(self, addr: int) -> int:
        """Map a staging (negative) address to its permanent address.

        Valid once ready() has assigned the base address (paper §5).
        """
        if self._base is None:
            raise RuntimeError("remap before ready()")
        return self._base + (addr - _LOCAL_BASE) if addr < 0 else addr

    # -- update operations ---------------------------------------------- #
    def append(self, text: str) -> Tuple[int, int]:
        """Append content; returns its (local) address interval.

        Single-token annotations are added automatically (paper §3) unless
        the featurizer maps the token to 0.
        """
        self._check_open()
        toks = self._tokenizer.tokenize(text)
        if not toks:
            raise ValueError("append of content with no tokens")
        lo = _LOCAL_BASE + self._local_next
        self._local_next += len(toks)
        offsets = np.array([[t.offset, t.length] for t in toks], dtype=np.int64)
        token_strs = tuple(t.text for t in toks)
        self._appends.append((lo, text, offsets, token_strs))
        for i, t in enumerate(token_strs):
            fval = self._featurizer.featurize(t)
            if fval != 0:
                self._ann.append((fval, lo + i, lo + i, 0.0))
        return (lo, lo + len(toks) - 1)

    def annotate(self, feature, p: int, q: int, v: float = 0.0,
                 v_is_address: bool = False) -> None:
        """Add ⟨f, (p,q), v⟩.  ``v_is_address`` marks the value as an address
        (graph edges, §2.5) so staging addresses get remapped at ready()."""
        self._check_open()
        fval = feature if isinstance(feature, int) else self._featurizer.featurize(feature)
        if fval == 0:
            return
        if q < p:
            raise ValueError("annotation with end < start")
        if v_is_address:
            self._addr_valued.append(len(self._ann))
        self._ann.append((fval, p, q, float(v)))

    def erase(self, p: int, q: int) -> None:
        """Remove content + annotations over [p, q] (reserved feature 0)."""
        self._check_open()
        if q < p:
            raise ValueError("erase with end < start")
        self._erase.append((p, q))

    # -- two-phase commit ------------------------------------------------ #
    def ready(self) -> None:
        self._check_open()
        index = self._index
        with index._addr_lock:       # brief global lock (paper §5)
            base = index._next_addr
            seq = index._next_seq
            index._next_addr += self._local_next
            index._next_seq += 1
        self._base = base
        remap = self.remap

        content = ContentStore()
        for lo, text, offsets, toks in self._appends:
            glo = remap(lo)
            content.add(AppendRecord(glo, glo + len(toks) - 1, text, offsets, toks))

        addr_valued = set(self._addr_valued)
        by_feature: Dict[int, List[Tuple[int, int, float]]] = {}
        for i, (fval, p, q, v) in enumerate(self._ann):
            if i in addr_valued:
                v = float(remap(int(v)))
            by_feature.setdefault(fval, []).append((remap(p), remap(q), v))
        postings: Dict[int, AnnotationList] = {}
        for fval, items in by_feature.items():
            s = np.array([i[0] for i in items], dtype=np.int64)
            e = np.array([i[1] for i in items], dtype=np.int64)
            v = np.array([i[2] for i in items], dtype=np.float64)
            postings[fval] = reduce_minimal(s, e, v)
        if self._erase:
            er_s = np.array([remap(p) for p, _ in self._erase], dtype=np.int64)
            er_e = np.array([remap(q) for _, q in self._erase], dtype=np.int64)
            erased = union_intervals([AnnotationList(
                er_s, er_e, np.zeros(er_s.size), _checked=True)])
        else:
            erased = AnnotationList.empty()

        self._segment = Segment(seq, base, self._local_next, content,
                                postings, erased)
        rec = self._segment.to_record()
        with index._durable_lock:       # vs. concurrent log compaction
            index._log.append(rec)
            index._pending[seq] = rec
        self._state = "ready"

    def commit(self) -> None:
        t0 = time.perf_counter()
        if self._state == "open":
            self.ready()
        if self._state != "ready":
            raise RuntimeError(f"commit in state {self._state}")
        index = self._index
        seq = self._segment.seqnum
        with index._durable_lock:
            index._log.append({"t": "commit", "seq": seq})
            index._pending.pop(seq, None)
            index._publish(self._segment)
        self._state = "committed"
        reg = obs.registry()
        if reg.enabled:
            reg.histogram(
                "txn_commit_latency_ms",
                "ready (if pending) + durable commit marker + publish"
            ).observe(1e3 * (time.perf_counter() - t0))
        index._maybe_auto_merge()

    def abort(self) -> None:
        if self._state == "ready":
            seq = self._segment.seqnum
            with self._index._durable_lock:
                self._index._log.append({"t": "abort", "seq": seq})
                self._index._pending.pop(seq, None)
        self._state = "aborted"  # address interval (if assigned) becomes a gap

    def _check_open(self) -> None:
        if self._state != "open":
            raise RuntimeError(f"transaction is {self._state}")


# --------------------------------------------------------------------- #
class DynamicIndex:
    """Fully dynamic annotative index with concurrent readers and writers."""

    def __init__(self, tokenizer: Optional[Tokenizer] = None,
                 featurizer: Optional[Featurizer] = None,
                 log_path: Optional[str] = None,
                 auto_merge_threshold: Optional[int] = None):
        self.tokenizer = tokenizer or Utf8Tokenizer()
        self.featurizer = featurizer or JsonFeaturizer()
        self._log = TransactionLog(log_path)
        self._segments: Tuple[Segment, ...] = ()
        self._version = 0
        self._next_addr = 0
        self._next_seq = 0
        self._addr_lock = threading.Lock()
        self._publish_lock = threading.Lock()
        self._cache: dict = {}
        self._cache_lock = threading.Lock()
        # size-tiered auto-merge: compact when the committed segment count
        # exceeds this (None = never, the historical behavior)
        self.auto_merge_threshold = auto_merge_threshold
        # serializes log compaction against ready/commit/abort log appends;
        # _pending holds readied-but-uncommitted records so a compaction
        # never drops the durable phase-1 frame of an in-flight transaction
        # contention-profiled as "wal" (lock_wait_ms{lock="wal"}):
        # group-commit stalls surface here first
        self._durable_lock = obs.ProfiledLock("wal", threading.RLock())
        self._pending: Dict[int, dict] = {}
        # merges are serialized; segments with seqnum <= _merge_fence are
        # off-limits to merge_segments (a tiered freeze is copying them out)
        self._merge_lock = threading.Lock()
        self._merge_fence = -1

    # -- reads ----------------------------------------------------------- #
    def snapshot(self) -> Snapshot:
        with self._publish_lock:
            return Snapshot(self._version, self._segments,
                            self._cache, self._cache_lock)

    # -- writes ---------------------------------------------------------- #
    def transaction(self) -> Transaction:
        return Transaction(self)

    def _publish(self, segment: Segment) -> None:
        with self._publish_lock:
            segs = list(self._segments)
            segs.append(segment)
            segs.sort(key=lambda s: s.seqnum)
            self._segments = tuple(segs)
            self._version += 1
            self._trim_cache()

    def _trim_cache(self) -> None:
        with self._cache_lock:
            stale = [k for k in self._cache if k[0] != self._version]
            # keep the latest version's entries plus nothing else; snapshots
            # pinned to older versions simply re-merge on demand.
            for k in stale:
                del self._cache[k]

    def _maybe_auto_merge(self) -> None:
        t = self.auto_merge_threshold
        if t is not None and len(self._segments) > t:
            self.merge_segments()

    # -- maintenance ------------------------------------------------------ #
    def merge_segments(self, upto: Optional[int] = None) -> None:
        """Background merge: compact committed segments into one subindex
        (paper: "warrens multiply like rabbits"), applying erases and
        logging the compacted state.  Segments at or below the merge fence
        (a tiered freeze in flight) are left untouched."""
        with self._merge_lock:
            fence = self._merge_fence
            with self._publish_lock:
                segs = self._segments
            victims = [s for s in segs
                       if (upto is None or s.seqnum <= upto)
                       and s.seqnum > fence]
            if len(victims) <= 1:
                return
            erased = union_intervals([s.erased for s in victims])
            feats: Dict[int, List[AnnotationList]] = {}
            for s in victims:
                for fval, lst in s.postings.items():
                    feats.setdefault(fval, []).append(lst)
            postings = {f: _filter_erased(merge_lists(ls), erased)
                        for f, ls in feats.items()}
            postings = {f: l for f, l in postings.items() if len(l)}
            content = ContentStore()
            for s in sorted(victims, key=lambda s: s.base):
                for r in s.content.records():
                    # drop fully erased records (GC of content)
                    if len(erased):
                        i = int(np.searchsorted(erased.starts, r.lo,
                                                side="right")) - 1
                        if i >= 0 and int(erased.ends[i]) >= r.hi:
                            continue
                    content.add(r)
            merged = Segment(max(s.seqnum for s in victims), 0, 0, content,
                             postings, erased)
            merged.length = sum(s.length for s in victims)
            merged.base = min(s.base for s in victims)
            with self._publish_lock:
                keep = [s for s in self._segments if s not in victims]
                self._segments = tuple(sorted([merged] + keep,
                                              key=lambda s: s.seqnum))
                self._version += 1
                self._trim_cache()
            self.compact_log()

    def compact_log(self) -> None:
        """Durably rewrite the log as the current committed segments plus
        the phase-1 frames of still-in-flight (readied) transactions."""
        with self._durable_lock:
            with self._publish_lock:
                segs = self._segments
            records = []
            for s in segs:
                records.append(s.to_record())
                records.append({"t": "commit", "seq": s.seqnum})
            records.extend(self._pending.values())
            self._log.compact(records)

    # -- tiered-storage entry points -------------------------------------- #
    def max_committed_seq(self) -> int:
        """Largest committed seqnum (-1 when empty)."""
        with self._publish_lock:
            return max((s.seqnum for s in self._segments), default=-1)

    def _set_merge_fence_impl(self, seqnum: int) -> None:
        """Exclude segments with seqnum <= ``seqnum`` from merges (a freeze
        is copying them into a static run); -1 lifts the fence.  Waits out
        any in-flight merge so the fenced set is stable on return."""
        with self._merge_lock:
            self._merge_fence = seqnum

    set_merge_fence = _set_merge_fence_impl   # see the note on ``_impl`` names

    def _detach_segments_impl(self, upto: int) -> Tuple[Segment, ...]:
        """Freeze-at-seqnum: atomically remove committed segments with
        seqnum <= ``upto`` from this index and return them.

        Pinned snapshots keep serving their immutable segment tuples; the
        caller owns making the detached data readable elsewhere (a static
        run published to a manifest) *before* calling this.  The log is NOT
        compacted here — call :meth:`compact_log` once the new tier is
        durable, so a crash in between recovers everything from the log.
        """
        with self._publish_lock:
            frozen = tuple(s for s in self._segments if s.seqnum <= upto)
            if frozen:
                self._segments = tuple(s for s in self._segments
                                       if s.seqnum > upto)
                self._version += 1
                self._trim_cache()
        return frozen

    detach_segments = _detach_segments_impl   # see the note on ``_impl`` names

    # -- recovery ---------------------------------------------------------- #
    @staticmethod
    def recover(log_path: str, tokenizer: Optional[Tokenizer] = None,
                featurizer: Optional[Featurizer] = None) -> "DynamicIndex":
        index = DynamicIndex(tokenizer, featurizer, log_path=None)
        ready: Dict[int, dict] = {}
        committed: List[Segment] = []
        log = TransactionLog(log_path)
        for rec in log.replay():
            if rec["t"] == "ready":
                ready[rec["seq"]] = rec
            elif rec["t"] == "commit" and rec["seq"] in ready:
                committed.append(Segment.from_record(ready.pop(rec["seq"])))
            elif rec["t"] == "abort":
                ready.pop(rec["seq"], None)
        log.close()
        committed.sort(key=lambda s: s.seqnum)
        index._segments = tuple(committed)
        index._version = 1
        if committed:
            index._next_seq = max(s.seqnum for s in committed) + 1
            index._next_addr = max(s.base + s.length for s in committed)
        # ready-without-commit transactions are aborted; their intervals are
        # gaps, so the next address must clear them too.
        for rec in ready.values():
            index._next_addr = max(index._next_addr, rec["base"] + rec["length"])
            index._next_seq = max(index._next_seq, rec["seq"] + 1)
        index._log = TransactionLog(log_path)
        return index
