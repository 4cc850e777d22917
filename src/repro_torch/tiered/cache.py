"""Admission-controlled block cache for mmap-served static runs.

The cache sits between :class:`~repro_torch.core.runfile.BlockRunReader` readers
and the mapped run files: keys are ``(device, inode, footer_crc, block)``
tuples, values are verified block payloads.  Capacity is in **bytes** and
the accounting is exact — every insert, evict, and pass-through is counted
under one lock, so the cache-invariant property tests can assert
``bytes == Σ len(entry)`` at any instant under concurrent readers.

Replacement is **segmented LRU** (probation + protected): a first hit
promotes an entry from probation to the protected segment (capped at
``protected_frac`` of capacity, overflow demotes back to probation MRU),
so one sequential scan cannot flush the hot working set.

Admission is **TinyLFU-style**: a count-min sketch of recent access
frequencies (4 rows, 8-bit counters, periodically halved so the window
ages) arbitrates every insert that would require an eviction — the
candidate must be *more* frequent than each victim it displaces, else the
candidate is rejected (``block_cache_admit_reject_total``) and the
resident blocks survive.  On skewed (Zipf) traces this beats plain LRU,
which is exactly the property test in ``tests/test_block_cache.py``.

**Pinning**: readers pin the blocks of an extent while assembling it and
bulk streams (compaction, run slicing) bypass admission entirely
(``admit=False``), so maintenance never thrashes serving.  Pinned entries
are never evicted and never demoted.

Capacity edge modes: ``capacity_bytes=0`` disables storage entirely (every
access is a pass-through miss); ``capacity_bytes=None`` is unbounded.
Read results are bit-identical across all three modes — the cache can only
ever change *where* a verified block payload comes from.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from repro_torch import obs

DEFAULT_CAPACITY = 64 * 1024 * 1024


class _Entry:
    __slots__ = ("value", "nbytes", "pins", "protected")

    def __init__(self, value: bytes):
        self.value = value
        self.nbytes = len(value)
        self.pins = 0
        self.protected = False


class _FrequencySketch:
    """Count-min sketch with periodic aging (the TinyLFU frequency
    estimator): 4 salted rows of 8-bit counters, all halved every
    ``sample_period`` increments so stale popularity decays."""

    ROWS = 4
    CAP = 255

    def __init__(self, width: int = 8192, sample_period: int = 65536):
        self.width = width
        self.sample_period = sample_period
        self._rows = np.zeros((self.ROWS, width), dtype=np.uint8)
        self._ops = 0

    def _slots(self, key):
        h = hash(key)
        for r in range(self.ROWS):
            yield r, (h ^ (0x9E3779B9 * (r + 1))) % self.width

    def add(self, key) -> None:
        for r, i in self._slots(key):
            if self._rows[r, i] < self.CAP:
                self._rows[r, i] += 1
        self._ops += 1
        if self._ops >= self.sample_period:
            self._rows >>= 1            # age the window
            self._ops = 0

    def estimate(self, key) -> int:
        return min(int(self._rows[r, i]) for r, i in self._slots(key))


class BlockCache:
    """Byte-capacity segmented-LRU block cache with TinyLFU admission."""

    def __init__(self, capacity_bytes: Optional[int] = DEFAULT_CAPACITY,
                 protected_frac: float = 0.8,
                 sketch_width: int = 8192):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 or None")
        self.capacity = capacity_bytes
        self.protected_frac = protected_frac
        self._lock = threading.Lock()
        self._entries: Dict[object, _Entry] = {}
        self._probation: "OrderedDict[object, None]" = OrderedDict()
        self._protected: "OrderedDict[object, None]" = OrderedDict()
        self._bytes = 0
        self._protected_bytes = 0
        self._sketch = _FrequencySketch(width=sketch_width)
        # exact local tallies (obs counters mirror them when enabled)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admit_rejects = 0

    # -- metrics -------------------------------------------------------- #
    def _note(self, kind: str, n: int = 1) -> None:
        reg = obs.registry()
        if not reg.enabled:
            return
        if kind == "hit":
            reg.counter("block_cache_hit_total",
                        "block cache hits").inc(n)
        elif kind == "miss":
            reg.counter("block_cache_miss_total",
                        "block cache misses (loaded from mmap)").inc(n)
        elif kind == "evict":
            reg.counter("block_cache_evict_total",
                        "blocks evicted by the segmented LRU").inc(n)
        elif kind == "admit_reject":
            reg.counter("block_cache_admit_reject_total",
                        "inserts rejected by TinyLFU admission").inc(n)
        reg.gauge("block_cache_bytes",
                  "resident block cache bytes").set(self._bytes)

    # -- core ----------------------------------------------------------- #
    def get(self, key) -> Optional[bytes]:
        with self._lock:
            self._sketch.add(key)
            e = self._entries.get(key)
            if e is None:
                return None
            self.hits += 1
            self._touch(key, e)
            self._note("hit")
            return e.value

    def get_or_load(self, key, loader, admit: bool = True) -> bytes:
        """Return the cached payload for ``key``, loading (and, by
        default, inserting) it on a miss.  ``admit=False`` is the bulk
        streaming mode: the loaded value is returned but never stored and
        never competes with resident entries."""
        got = self.get(key)
        if got is not None:
            return got
        value = loader()
        with self._lock:
            self.misses += 1
            self._note("miss")
            if admit and self.capacity != 0:
                self._put_locked(key, value)
            e = self._entries.get(key)
            return e.value if e is not None else value

    def _touch(self, key, e: _Entry) -> None:
        """Segmented-LRU hit path: probation -> protected promotion."""
        if e.protected:
            self._protected.move_to_end(key)
            return
        del self._probation[key]
        e.protected = True
        self._protected[key] = None
        self._protected_bytes += e.nbytes
        cap = self._protected_cap()
        if cap is None:
            return
        # overflow demotes the protected LRU back to probation MRU
        while self._protected_bytes > cap:
            victim = self._first_unpinned(self._protected)
            if victim is None or victim == key:
                break
            ve = self._entries[victim]
            del self._protected[victim]
            ve.protected = False
            self._probation[victim] = None
            self._protected_bytes -= ve.nbytes

    def _protected_cap(self) -> Optional[int]:
        if self.capacity is None:
            return None
        return int(self.capacity * self.protected_frac)

    def _first_unpinned(self, seg: "OrderedDict[object, None]"):
        for key in seg:                  # LRU -> MRU
            if self._entries[key].pins == 0:
                return key
        return None

    def _put_locked(self, key, value: bytes) -> None:
        if key in self._entries:
            return                       # raced with another loader
        nbytes = len(value)
        if self.capacity is not None:
            if nbytes > self.capacity:
                self.admit_rejects += 1
                self._note("admit_reject")
                return
            cand_freq = self._sketch.estimate(key)
            while self._bytes + nbytes > self.capacity:
                victim = self._first_unpinned(self._probation)
                if victim is None:
                    victim = self._first_unpinned(self._protected)
                if victim is None:       # everything resident is pinned
                    self.admit_rejects += 1
                    self._note("admit_reject")
                    return
                # TinyLFU: the newcomer must beat every block it displaces
                if self._sketch.estimate(victim) >= cand_freq:
                    self.admit_rejects += 1
                    self._note("admit_reject")
                    return
                self._evict_locked(victim)
        e = _Entry(value)
        self._entries[key] = e
        self._probation[key] = None
        self._bytes += nbytes

    def _evict_locked(self, key) -> None:
        e = self._entries.pop(key)
        if e.protected:
            del self._protected[key]
            self._protected_bytes -= e.nbytes
        else:
            del self._probation[key]
        self._bytes -= e.nbytes
        self.evictions += 1
        self._note("evict")

    # -- pinning -------------------------------------------------------- #
    def pin(self, key) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.pins += 1

    def unpin(self, key) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.pins > 0:
                e.pins -= 1

    # -- introspection --------------------------------------------------- #
    def invalidate(self) -> None:
        """Drop every unpinned entry (tests; capacity reconfiguration)."""
        with self._lock:
            for key in [k for k, e in self._entries.items() if e.pins == 0]:
                e = self._entries.pop(key)
                (self._protected if e.protected
                 else self._probation).pop(key, None)
                self._bytes -= e.nbytes
                if e.protected:
                    self._protected_bytes -= e.nbytes

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        """The ``/tiered/cache`` admin document."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "capacity_bytes": self.capacity,
                "bytes": self._bytes,
                "protected_bytes": self._protected_bytes,
                "entries": len(self._entries),
                "pinned": sum(1 for e in self._entries.values() if e.pins),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "admit_rejects": self.admit_rejects,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
            }

    def check_accounting(self) -> None:
        """Assert the exact-bytes invariant (property-test hook)."""
        with self._lock:
            total = sum(e.nbytes for e in self._entries.values())
            prot = sum(e.nbytes for e in self._entries.values()
                       if e.protected)
            assert total == self._bytes, (total, self._bytes)
            assert prot == self._protected_bytes, (prot,
                                                   self._protected_bytes)
            assert set(self._entries) == (set(self._probation)
                                          | set(self._protected))
            assert not (set(self._probation) & set(self._protected))


# --------------------------------------------------------------------- #
_default_lock = threading.Lock()
_default: Optional[BlockCache] = None


def default_block_cache() -> BlockCache:
    """The process-wide cache every TieredStore/StaticWarren shares unless
    given its own; capacity from ``REPRO_BLOCK_CACHE_BYTES`` (default
    64 MiB)."""
    global _default
    with _default_lock:
        if _default is None:
            cap = int(os.environ.get("REPRO_BLOCK_CACHE_BYTES",
                                     DEFAULT_CAPACITY))
            _default = BlockCache(capacity_bytes=cap)
        return _default


def set_default_block_cache(cache: Optional[BlockCache]) -> None:
    global _default
    with _default_lock:
        _default = cache
