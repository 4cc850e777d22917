"""Static index: larger-than-memory collections, batch update model (paper §3).

Two on-disk layouts share one reader class:

**v2 (current, block-oriented)** — one ``run.aix2`` file per directory
(:mod:`repro_torch.core.runfile`): fixed-size crc'd blocks holding per-feature
posting blobs and per-record compressed content payloads, indexed by a
MessagePack footer of extents, closed by a fixed trailer.  The reader ``mmap``'s
the file, parses only footer + trailer eagerly, and decodes *lazily per
block* through a pluggable block cache — content is **not** materialized
into a resident ContentStore, so corpus size is bounded by disk, not RAM.

**v1 (legacy, read-only)** — four files (``meta.msgpack`` /
``features.msgpack`` / ``postings.bin`` / ``content.bin``) with the content
store decoded resident at open.  v1 directories keep opening forever
(back-compat fixture under ``tests/fixtures/``); all new writes are v2.

Reads decode one feature at a time (LRU cached) — annotation lists are
"compressed until active".  Batch update = build a merged directory from the
current one plus new documents, then atomic rename; a lock file enforces the
single-transaction rule.

The same layout doubles as the immutable *run* format of the tiered storage
engine (``repro_torch.tiered``): :func:`write_run` freezes a slice of committed
dynamic segments into one directory (meta gains seq/addr bounds),
:func:`merge_runs` folds several runs into one (optionally GC'ing erased
records — the tiered engine does that only at the bottom level),
:func:`slice_run` cuts a run to an address subrange by footer-index extents
(raw content payloads are copied without decompression — the sliced-run
shipping path of cold rebalancing), and :meth:`StaticIndex.to_segment`
streams a run back into the dynamic ``Segment`` form for resurrection.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import codec, packing, vbyte
from .annotation import AnnotationList, merge_lists, union_intervals
from .faults import fault_point
from .featurizer import Featurizer, JsonFeaturizer
from .gcl import Term
from .index import (DynamicIndex, Segment, Snapshot, _filter_erased,
                    erased_overlaps, tokens_sources, translate_sources)
from .runfile import (DEFAULT_BLOCK_SIZE, RUN_FILE, BlockRunReader,
                      BlockRunWriter, RunCorruption, is_v2_dir)
from .tokenizer import Tokenizer, Utf8Tokenizer
from .txt import AppendRecord, ContentStore

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

__all__ = [
    "StaticIndex", "RunCorruption", "write_static", "write_run",
    "merge_runs", "slice_run", "write_carrier_run", "run_bytes",
]


def _pack_record_payload(rec: dict) -> bytes:
    """Durable-form content record dict -> compressed v2 payload."""
    return codec.compress(packing.packb(
        {"text": rec["text"], "off": rec["off"], "tok": rec["tok"]}),
        level=6)


def _unpack_record_payload(lo: int, hi: int, payload: bytes) -> AppendRecord:
    try:
        obj = packing.unpackb(codec.decompress(payload))
        off = np.frombuffer(obj["off"], dtype=np.int64).reshape(-1, 2)
        return AppendRecord(lo, hi, obj["text"], off, tuple(obj["tok"]))
    except RunCorruption:
        raise
    except Exception as e:
        raise RunCorruption(
            f"content record [{lo}, {hi}] undecodable: {e}") from e


class LazyContentStore:
    """ContentStore surface over v2 footer extents — nothing resident.

    Record address bounds come from the footer; payloads are fetched
    through the block cache and decoded on demand, with a small LRU of
    decoded records so a ``translate`` burst over one document does not
    re-inflate it per call.  Iterating ``records()`` streams decodes (the
    resurrection / merge paths) without retaining more than the LRU.
    """

    def __init__(self, reader: BlockRunReader, decoded_lru: int = 64):
        self._reader = reader
        self._extents = reader.records     # [(lo, hi, off, nbytes), ...]
        self._los = [r[0] for r in self._extents]
        self._lru: "OrderedDict[int, AppendRecord]" = OrderedDict()
        self._lru_size = decoded_lru
        self._lock = threading.Lock()

    # -- lazy record access --------------------------------------------- #
    def __len__(self) -> int:
        return len(self._extents)

    def record_bounds(self) -> List[Tuple[int, int]]:
        return [(r[0], r[1]) for r in self._extents]

    def decode(self, i: int) -> AppendRecord:
        with self._lock:
            got = self._lru.get(i)
            if got is not None:
                self._lru.move_to_end(i)
                return got
        lo, hi, off, nbytes = self._extents[i]
        rec = _unpack_record_payload(lo, hi, self._reader.read(off, nbytes))
        with self._lock:
            self._lru[i] = rec
            while len(self._lru) > self._lru_size:
                self._lru.popitem(last=False)
        return rec

    def raw_payload(self, i: int) -> bytes:
        """The stored (compressed) payload, streamed cache-neutrally —
        the no-decode copy path of merges and slicing."""
        lo, hi, off, nbytes = self._extents[i]
        return b"".join(self._reader.stream(off, nbytes, admit=False))

    def records(self) -> "_LazyRecords":
        return _LazyRecords(self)

    def add(self, record) -> None:
        raise TypeError("LazyContentStore is immutable (on-disk run)")

    # -- Txt surface ---------------------------------------------------- #
    def span(self) -> Tuple[int, int]:
        if not self._extents:
            return (0, -1)
        return (self._extents[0][0], self._extents[-1][1])

    def _covering(self, p: int, q: int) -> Optional[List[AppendRecord]]:
        if not self._extents or q < p:
            return None
        i = bisect.bisect_right(self._los, p) - 1
        if i < 0:
            return None
        out: List[AppendRecord] = []
        expect = p
        while expect <= q:
            if i >= len(self._extents):
                return None
            lo, hi = self._extents[i][0], self._extents[i][1]
            if not (lo <= expect <= hi):
                return None
            out.append(self.decode(i))
            expect = hi + 1
            i += 1
        return out

    def translate(self, p: int, q: int) -> Optional[str]:
        recs = self._covering(p, q)
        if recs is None:
            return None
        parts = []
        for r in recs:
            first = max(p, r.lo) - r.lo
            last = min(q, r.hi) - r.lo
            c0 = int(r.offsets[first, 0])
            c1 = int(r.offsets[last, 0] + r.offsets[last, 1])
            parts.append(r.text[c0:c1])
        return " ".join(parts)

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        recs = self._covering(p, q)
        if recs is None:
            return None
        out: List[str] = []
        for r in recs:
            first = max(p, r.lo) - r.lo
            last = min(q, r.hi) - r.lo
            out.extend(r.tokens[first:last + 1])
        return out


class _LazyRecords(Sequence):
    """Sequence view over a LazyContentStore: truthiness and ``len`` come
    from the footer (no decode); indexing/iteration decode on demand."""

    def __init__(self, store: LazyContentStore):
        self._store = store

    def __len__(self) -> int:
        return len(self._store)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._store.decode(j)
                    for j in range(*i.indices(len(self._store)))]
        return self._store.decode(i)

    def __iter__(self):
        for i in range(len(self._store)):
            yield self._store.decode(i)


class StaticIndex:
    """Read-optimized on-disk annotative index (v2 mmap'd, v1 resident)."""

    def __init__(self, directory: str, tokenizer: Optional[Tokenizer] = None,
                 featurizer: Optional[Featurizer] = None,
                 cache_size: int = 256, block_cache=None):
        self.directory = directory
        self.tokenizer = tokenizer or Utf8Tokenizer()
        self.featurizer = featurizer or JsonFeaturizer()
        self._cache: "OrderedDict[int, AnnotationList]" = OrderedDict()
        self._cache_size = cache_size
        self._lock = threading.Lock()
        self._reader: Optional[BlockRunReader] = None
        self._fh = None
        if is_v2_dir(directory):
            self.layout = 2
            self._open_v2(directory, block_cache)
        elif os.path.exists(os.path.join(directory, "meta.msgpack")):
            self.layout = 1
            self._open_v1(directory)
        else:
            raise RunCorruption(
                f"{directory}: neither a v2 run ({RUN_FILE}) nor a v1 "
                "static directory (meta.msgpack)")
        n_er = self.meta.get("er_n", 0)
        self._erased = AnnotationList(
            vbyte.decode_gaps(self.meta.get("er_s", b""), n_er),
            vbyte.decode_gaps(self.meta.get("er_e", b""), n_er),
            np.zeros(n_er), _checked=True)

    # -- open ------------------------------------------------------------ #
    def _open_v2(self, directory: str, block_cache) -> None:
        self._reader = BlockRunReader(os.path.join(directory, RUN_FILE),
                                      cache=block_cache)
        self.meta = dict(self._reader.meta)
        self._features: Dict[int, Tuple[int, int, int]] = \
            dict(self._reader.features)
        self._content = LazyContentStore(self._reader)

    def _open_v1(self, directory: str) -> None:
        with open(os.path.join(directory, "meta.msgpack"), "rb") as fh:
            self.meta = packing.unpackb(fh.read())
        with open(os.path.join(directory, "features.msgpack"), "rb") as fh:
            self._features = {
                int(k): tuple(v)
                for k, v in packing.unpackb(fh.read()).items()}
        self._postings_path = os.path.join(directory, "postings.bin")
        with open(os.path.join(directory, "content.bin"), "rb") as fh:
            recs = packing.unpackb(codec.decompress(fh.read()))
        self._content = ContentStore()
        for a in recs:
            off = np.frombuffer(a["off"], dtype=np.int64).reshape(-1, 2)
            self._content.add(AppendRecord(a["lo"], a["hi"], a["text"], off,
                                           tuple(a["tok"])))
        self._fh = open(self._postings_path, "rb")

    # -- reads (same surface as Snapshot) ------------------------------- #
    def _postings_blob(self, offset: int, nbytes: int) -> bytes:
        if self._reader is not None:
            return self._reader.read(offset, nbytes)
        with self._lock:
            self._fh.seek(offset)
            return self._fh.read(nbytes)

    def annotations(self, feature) -> AnnotationList:
        fval = (feature if isinstance(feature, int)
                else self.featurizer.featurize(feature))
        with self._lock:
            if fval in self._cache:
                self._cache.move_to_end(fval)
                return self._cache[fval]
        loc = self._features.get(fval)
        if loc is None:
            return AnnotationList.empty()
        offset, nbytes, count = loc
        blob = self._postings_blob(offset, nbytes)
        try:
            ns, ne = struct.unpack("<II", blob[:8])
            s = vbyte.decode_gaps(blob[8:8 + ns], count)
            e = vbyte.decode_gaps(blob[8 + ns:8 + ns + ne], count)
            v = np.frombuffer(blob[8 + ns + ne:], dtype=np.float64)
            if len(s) != count or len(e) != count or len(v) != count:
                raise ValueError(f"expected {count} postings")
        except RunCorruption:
            raise
        except Exception as exc:
            raise RunCorruption(
                f"{self.directory}: posting list for feature {fval} "
                f"undecodable: {exc}") from exc
        lst = AnnotationList(s, e, v, _checked=True)
        with self._lock:
            self._cache[fval] = lst
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return lst

    def hopper(self, feature) -> Term:
        return Term(self.annotations(feature))

    def translate(self, p: int, q: int) -> Optional[str]:
        if erased_overlaps(self._erased, p, q):
            return None
        return translate_sources([self._content], p, q)

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        if erased_overlaps(self._erased, p, q):
            return None
        return tokens_sources([self._content], p, q)

    # -- run accessors (tiered storage) --------------------------------- #
    @property
    def erased(self) -> AnnotationList:
        """Persisted erased intervals (tombstones of this run)."""
        return self._erased

    @property
    def content(self) -> Union[ContentStore, LazyContentStore]:
        return self._content

    def features(self) -> List[int]:
        """All feature values with a stored annotation list, sorted."""
        return sorted(self._features)

    def record_bounds(self) -> List[Tuple[int, int]]:
        """``(lo, hi)`` address bounds per content record, footer-only for
        v2 (no decode) — pivot selection for sliced-run rebalancing."""
        if isinstance(self._content, LazyContentStore):
            return self._content.record_bounds()
        return [(r.lo, r.hi) for r in self._content.records()]

    def to_segment(self, seqnum: Optional[int] = None) -> Segment:
        """Materialize the whole run as a dynamic :class:`Segment` (loads
        every annotation list and — for v2 — decodes every content record
        into a resident store) — the resurrection path back to the hot
        tier; fan out to replicas via ``Segment.to_record``.  This is the
        one deliberately non-lazy read: promotion means going hot."""
        postings = {f: self.annotations(f) for f in self.features()}
        content = self._content
        if isinstance(content, LazyContentStore):
            resident = ContentStore()
            for rec in content.records():
                resident.add(rec)
            content = resident
        seq = seqnum if seqnum is not None else int(self.meta.get("seq_hi", 0))
        lo = int(self.meta.get("addr_lo", 0))
        hi = int(self.meta.get("addr_hi", -1))
        return Segment(seq, lo, max(0, hi - lo + 1), content, postings,
                       self._erased)

    # warren-compat helpers
    def featurize(self, feature: str) -> int:
        return self.featurizer.featurize(feature)

    @property
    def index(self):  # parity with Warren.phrase
        return self

    def phrase(self, text: str):
        from .gcl import Phrase
        from .annotation import AnnotationList as _AL
        words = self.tokenizer.split(text)
        terms = [self.hopper(w) for w in words]
        if not terms:
            return Term(_AL.empty())
        return terms[0] if len(terms) == 1 else Phrase(terms)

    def file_bytes(self) -> int:
        """On-disk size of this run (level-target accounting)."""
        return run_bytes(self.directory)

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
        if self._fh is not None:
            self._fh.close()

    def __del__(self):
        # last-resort fd cleanup: runs retired by a tiered compaction are
        # dropped without close() once no pinned snapshot references them
        try:
            self.close()
        except Exception:
            pass


def run_bytes(directory: str) -> int:
    """Total on-disk bytes of a run directory (v1 or v2)."""
    total = 0
    try:
        for fn in os.listdir(directory):
            try:
                total += os.path.getsize(os.path.join(directory, fn))
            except OSError:
                pass
    except OSError:
        pass
    return total


def _gc_records(records, erased: AnnotationList) -> List[dict]:
    """Durable-form content records minus those fully covered by an erased
    interval; partially-erased spans stay and are hidden at read time."""
    recs = []
    for r in records:
        if _record_fully_erased(r.lo, r.hi, erased):
            continue
        recs.append({"lo": r.lo, "hi": r.hi, "text": r.text,
                     "off": np.asarray(r.offsets, dtype=np.int64).tobytes(),
                     "tok": list(r.tokens)})
    recs.sort(key=lambda r: r["lo"])
    return recs


def _record_fully_erased(lo: int, hi: int, erased: AnnotationList) -> bool:
    if not len(erased):
        return False
    i = int(np.searchsorted(erased.starts, lo, side="right")) - 1
    return i >= 0 and int(erased.ends[i]) >= hi


class _RawRecord:
    """A content record travelling as its stored compressed payload —
    footer bounds + bytes, never decoded (merge/slice copy path)."""

    __slots__ = ("lo", "hi", "payload")

    def __init__(self, lo: int, hi: int, payload: bytes):
        self.lo = lo
        self.hi = hi
        self.payload = payload


def _write_layout(directory: str,
                  feats_items: Iterable[Tuple[int, AnnotationList]],
                  erased: AnnotationList,
                  recs: Iterable,
                  extra_meta: Optional[dict] = None,
                  block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Write the v2 block layout into a build directory, then publish it
    with an atomic rename.  ``feats_items`` streams ``(fval, list)`` pairs
    and ``recs`` streams either durable-form dicts or :class:`_RawRecord`
    payloads (sorted by ``lo``) — nothing is required to be materialized.
    Returns the meta record (with address bounds and ``nbytes``)."""
    build = directory + ".build"
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, RUN_FILE)
    writer = BlockRunWriter(path, block_size=block_size)
    addr_lo, addr_hi = None, None

    def _bound(lo: int, hi: int) -> None:
        nonlocal addr_lo, addr_hi
        addr_lo = lo if addr_lo is None else min(addr_lo, lo)
        addr_hi = hi if addr_hi is None else max(addr_hi, hi)

    try:
        offsets: Dict[int, Tuple[int, int, int]] = {}
        for fval, lst in feats_items:
            s = vbyte.encode_gaps(lst.starts)
            e = vbyte.encode_gaps(lst.ends)
            blob = (struct.pack("<II", len(s), len(e)) + s + e
                    + lst.values.tobytes())
            pos, nbytes = writer.append(blob)
            offsets[fval] = (pos, nbytes, len(lst))
            if len(lst):
                _bound(int(lst.starts[0]), int(lst.ends[-1]))
        record_index: List[Tuple[int, int, int, int]] = []
        for rec in recs:
            if isinstance(rec, _RawRecord):
                lo, hi, payload = rec.lo, rec.hi, rec.payload
            else:
                lo, hi, payload = rec["lo"], rec["hi"], \
                    _pack_record_payload(rec)
            pos, nbytes = writer.append(payload)
            record_index.append((lo, hi, pos, nbytes))
            _bound(lo, hi)
        if len(erased):
            _bound(int(erased.starts[0]), int(erased.ends[-1]))
        meta = {"n_features": len(offsets), "n_records": len(record_index),
                "er_n": len(erased),
                "er_s": vbyte.encode_gaps(erased.starts),
                "er_e": vbyte.encode_gaps(erased.ends),
                "layout": 2,
                "addr_lo": int(addr_lo if addr_lo is not None else 0),
                "addr_hi": int(addr_hi if addr_hi is not None else -1)}
        meta.update(extra_meta or {})
        writer.finish(offsets, record_index, meta)
    except BaseException:
        writer.abort()
        raise
    meta["nbytes"] = os.path.getsize(path)
    fault_point("static.pre_publish")
    if os.path.exists(directory):
        import shutil
        shutil.rmtree(directory + ".old", ignore_errors=True)
        os.rename(directory, directory + ".old")
        os.rename(build, directory)
        shutil.rmtree(directory + ".old", ignore_errors=True)
    else:
        os.rename(build, directory)
    fault_point("static.published")
    return meta


def _write_layout_v1(directory: str, feats: Dict[int, AnnotationList],
                     erased: AnnotationList, recs: List[dict],
                     extra_meta: Optional[dict] = None) -> dict:
    """The legacy four-file layout — retained ONLY to regenerate the
    back-compat fixture (``tests/fixtures/v1_run``); every production
    write path emits v2."""
    build = directory + ".build"
    os.makedirs(build, exist_ok=True)
    offsets: Dict[int, Tuple[int, int, int]] = {}
    with open(os.path.join(build, "postings.bin"), "wb") as fh:
        pos = 0
        for fval, lst in feats.items():
            s = vbyte.encode_gaps(lst.starts)
            e = vbyte.encode_gaps(lst.ends)
            blob = (struct.pack("<II", len(s), len(e)) + s + e
                    + lst.values.tobytes())
            fh.write(blob)
            offsets[fval] = (pos, len(blob), len(lst))
            pos += len(blob)
        fh.flush()
        os.fsync(fh.fileno())
    with open(os.path.join(build, "features.msgpack"), "wb") as fh:
        fh.write(packing.packb({str(k): list(v) for k, v in offsets.items()}))
        fh.flush()
        os.fsync(fh.fileno())
    with open(os.path.join(build, "content.bin"), "wb") as fh:
        fh.write(codec.compress(packing.packb(recs), level=6))
        fh.flush()
        os.fsync(fh.fileno())
    meta = {"n_features": len(feats), "n_records": len(recs),
            "er_n": len(erased),
            "er_s": vbyte.encode_gaps(erased.starts),
            "er_e": vbyte.encode_gaps(erased.ends)}
    meta.update(extra_meta or {})
    with open(os.path.join(build, "meta.msgpack"), "wb") as fh:
        fh.write(packing.packb(meta))
        fh.flush()
        os.fsync(fh.fileno())
    if os.path.exists(directory):
        import shutil
        shutil.rmtree(directory + ".old", ignore_errors=True)
        os.rename(directory, directory + ".old")
        os.rename(build, directory)
        shutil.rmtree(directory + ".old", ignore_errors=True)
    else:
        os.rename(build, directory)
    return meta


def write_static(snapshot_like, directory: str) -> None:
    """Freeze a DynamicIndex snapshot (or anything exposing segments) into
    the on-disk static layout."""
    if isinstance(snapshot_like, Snapshot):
        snap = snapshot_like
    else:
        snap = snapshot_like.snapshot()
    feats: Dict[int, AnnotationList] = {}
    fvals = set()
    for seg in snap.segments:
        fvals.update(seg.postings.keys())
    for fval in fvals:
        lst = snap.annotations(fval)
        if len(lst):
            feats[fval] = lst
    erased = snap.erased
    recs = _gc_records([r for seg in snap.segments
                        for r in seg.content.records()], erased)
    _write_layout(directory, feats.items(), erased, recs)


def _write_static_v1(snapshot_like, directory: str) -> None:
    """``write_static`` but emitting the legacy v1 four-file layout — only
    for the back-compat fixture and the v1-reader regression tests."""
    if isinstance(snapshot_like, Snapshot):
        snap = snapshot_like
    else:
        snap = snapshot_like.snapshot()
    feats: Dict[int, AnnotationList] = {}
    fvals = set()
    for seg in snap.segments:
        fvals.update(seg.postings.keys())
    for fval in fvals:
        lst = snap.annotations(fval)
        if len(lst):
            feats[fval] = lst
    erased = snap.erased
    recs = _gc_records([r for seg in snap.segments
                        for r in seg.content.records()], erased)
    _write_layout_v1(directory, feats, erased, recs)


def _write_run_impl(segments: Sequence[Segment], directory: str,
              block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Freeze committed dynamic segments into one immutable *run* directory
    (the tiered storage engine's on-disk tier).

    Postings are k-way merged in sequence order and filtered by the
    segments' own erased set; fully-erased content records are GC'd;
    partially-erased spans and erases targeting *older* runs survive as
    tombstones in the persisted erased list, so a reader merging runs in
    sequence order reconstructs exactly the dynamic semantics.  Returns the
    meta record (with ``seq_lo/seq_hi/addr_lo/addr_hi`` bounds).
    """
    segments = sorted(segments, key=lambda s: s.seqnum)
    if not segments:
        raise ValueError("write_run of an empty segment set")
    erased = union_intervals([s.erased for s in segments])
    by_feature: Dict[int, List[AnnotationList]] = {}
    for seg in segments:                       # sequence order: last wins
        for fval, lst in seg.postings.items():
            by_feature.setdefault(fval, []).append(lst)
    feats = {f: _filter_erased(merge_lists(ls), erased)
             for f, ls in by_feature.items()}
    feats = {f: l for f, l in feats.items() if len(l)}
    recs = _gc_records([r for seg in segments
                        for r in seg.content.records()], erased)
    return _write_layout(directory, feats.items(), erased, recs, {
        "seq_lo": int(segments[0].seqnum),
        "seq_hi": int(segments[-1].seqnum)}, block_size=block_size)


write_run = _write_run_impl   # see the note on ``_impl`` names


def _merged_record_stream(runs: List[StaticIndex], erased: AnnotationList,
                          gc_records: bool):
    """Stream every surviving content record across ``runs`` in address
    order — raw compressed payloads for v2 sources (no decode), durable
    dicts for v1.  Lazily: only footer bounds are materialized up front."""
    entries = []                     # (lo, hi, run_idx, rec_idx)
    for ri, r in enumerate(runs):
        for i, (lo, hi) in enumerate(r.record_bounds()):
            entries.append((lo, hi, ri, i))
    entries.sort(key=lambda t: t[0])
    for lo, hi, ri, i in entries:
        if gc_records and _record_fully_erased(lo, hi, erased):
            continue
        content = runs[ri].content
        if isinstance(content, LazyContentStore):
            yield _RawRecord(lo, hi, content.raw_payload(i))
        else:
            rec = content.records()[i]
            yield {"lo": rec.lo, "hi": rec.hi, "text": rec.text,
                   "off": np.asarray(rec.offsets,
                                     dtype=np.int64).tobytes(),
                   "tok": list(rec.tokens)}


def _merge_runs_impl(run_dirs: List[str], directory: str,
               gc_records: bool = True,
               block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Fold several runs (oldest first — recency order of the caller's
    read path) into one.

    With ``gc_records`` (bottom-level compaction), records fully covered
    by the union of the runs' tombstones are dropped; upper-level merges
    pass False and defer the GC, matching classic leveled doctrine.  The
    tombstones themselves are *always* retained — annotative indexing lets
    later transactions annotate erased address ranges, so a tombstone
    keeps filtering reads forever (unlike classic LSM deletes, it can
    never be dropped once no older run exists).  v2 sources stream their
    content payloads without decompression.  Returns the merged meta
    record.
    """
    if not run_dirs:
        raise ValueError("merge_runs of an empty run set")
    runs = [StaticIndex(d) for d in run_dirs]
    try:
        erased = union_intervals([r.erased for r in runs])
        fvals = sorted({f for r in runs for f in r.features()})

        def feats_stream():
            for fval in fvals:
                lst = _filter_erased(
                    merge_lists([r.annotations(fval) for r in runs]),
                    erased)
                if len(lst):
                    yield fval, lst

        recs = _merged_record_stream(runs, erased, gc_records)
        return _write_layout(directory, feats_stream(), erased, recs, {
            "seq_lo": min(int(r.meta.get("seq_lo", 0)) for r in runs),
            "seq_hi": max(int(r.meta.get("seq_hi", 0)) for r in runs)},
            block_size=block_size)
    finally:
        for r in runs:
            r.close()


merge_runs = _merge_runs_impl   # see the note on ``_impl`` names


def write_carrier_run(directory: str, erased: AnnotationList,
                      seq_lo: int = 0, seq_hi: int = 0,
                      block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Write a run holding *only* tombstones (no postings, no content) —
    the erased-carrier of sliced-run shipping: when whole runs are copied
    to one side of a split, the other side still needs the full tombstone
    union so cross-run erases keep filtering its reads."""
    return _write_layout(directory, [], erased, [], {
        "seq_lo": int(seq_lo), "seq_hi": int(seq_hi)},
        block_size=block_size)


def slice_run(run_dir: str, directory: str, lo: int, hi: int,
              erased_override: Optional[AnnotationList] = None,
              invert: bool = False,
              block_size: int = DEFAULT_BLOCK_SIZE) -> Optional[dict]:
    """Cut one run to the address window ``[lo, hi)`` — or, with
    ``invert``, to the window's complement — by footer-index extents: the
    sliced-run shipping path of cold-group rebalancing.

    Postings are sliced per feature (an annotation belongs to the side
    owning its *start* address — the cross-shard routing rule); content
    records travel with their first address, copied as **raw compressed
    payloads** for v2 sources (no decode, no decompress).  The output
    carries ``erased_override`` (callers pass the source group's full
    tombstone union — a tombstone recorded anywhere may cover either
    side), or the source run's own tombstones.  Returns the sliced meta
    record, or None when nothing (no postings, records, or tombstones)
    lands on the selected side.
    """
    src = StaticIndex(run_dir)
    try:
        erased = (erased_override if erased_override is not None
                  else src.erased)

        def feats_stream():
            for fval in src.features():
                lst = src.annotations(fval)
                mask = (lst.starts >= lo) & (lst.starts < hi)
                if invert:
                    mask = ~mask
                if not mask.any():
                    continue
                if mask.all():
                    yield fval, lst
                else:
                    yield fval, AnnotationList(
                        lst.starts[mask], lst.ends[mask], lst.values[mask],
                        _checked=True)

        def recs_stream():
            content = src.content
            for i, (rlo, rhi) in enumerate(src.record_bounds()):
                if (lo <= rlo < hi) == invert:
                    continue
                if isinstance(content, LazyContentStore):
                    yield _RawRecord(rlo, rhi, content.raw_payload(i))
                else:
                    rec = content.records()[i]
                    yield {"lo": rec.lo, "hi": rec.hi, "text": rec.text,
                           "off": np.asarray(rec.offsets,
                                             dtype=np.int64).tobytes(),
                           "tok": list(rec.tokens)}

        meta = _write_layout(directory, feats_stream(), erased,
                             recs_stream(), {
                                 "seq_lo": int(src.meta.get("seq_lo", 0)),
                                 "seq_hi": int(src.meta.get("seq_hi", 0))},
                             block_size=block_size)
        if (meta["n_features"] == 0 and meta["n_records"] == 0
                and meta["er_n"] == 0):
            import shutil
            shutil.rmtree(directory, ignore_errors=True)
            return None
        return meta
    finally:
        src.close()
