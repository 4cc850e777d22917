"""repro_torch.tiered — LSM-style tiered storage for the annotative index.

  manifest      versioned atomic-JSON manifests with latest-good recovery
  store         TieredStore / TieredSnapshot / TieredWarren / StaticWarren
                + demote_index / resurrect_index (cold shard demotion)
                + merge_demoted / split_demoted (manifest-shipping
                rebalance of cold groups, sliced run sets — no promotion)
  compaction    background Compactor + LeveledPolicy + pause-time metrics
  cache         BlockCache: byte-capacity segmented-LRU with TinyLFU
                admission, shared by every mmap'd v2 run reader

Semantics.  A :class:`TieredWarren` exposes the *exact* Warren surface
over a hot :class:`~repro_torch.core.index.DynamicIndex` memtable plus N
immutable on-disk static runs.  Every read pins a
:class:`TieredSnapshot` — an immutable (runs, hot-snapshot) pair — and
per-feature views k-way merge run lists with the hot list in sequence
order, filtered by the coalescing union of every tier's tombstones, so a
tiered index is bit-identical to the single dynamic index holding the same
committed transactions.  Writes only ever touch the hot tier; ``freeze``
folds committed hot segments into a new run and ``merge`` folds runs
together, both in the background.

Invariants the rest of the system leans on:

* **Readers never block.**  The only stop-the-world window in a freeze or
  merge is the view swap (a tuple assignment + ``detach_segments``),
  measured and reported as compaction pause time.  Pinned snapshots keep
  serving their run tuple and segment tuple forever — run file handles
  stay valid past unlink (POSIX), content is resident.
* **The manifest is the commit point.**  A run is durable on disk *before*
  the manifest version naming it is published (tmp + fsync + atomic
  rename), and the hot tier forgets frozen segments only *after* the
  publish; the WAL is compacted last.  Every crash point therefore
  recovers to latest-good manifest + WAL replay, with already-frozen
  segments deduplicated at open and orphan run directories GC'd.
* **Erasure is a point-set.**  Tombstones merge as a coalescing interval
  union across *all* tiers — an erase recorded in any tier hides content
  and annotations in every other tier, and survives run merges.
* **Levels order recency.**  Leveled compaction keeps runs address-
  disjoint within each level ``>= 1``; the read path merges deepest level
  first, then ascending sequence, hot tier last, so exact-interval ties
  still resolve newest-wins.  Erased content records are GC'd only when a
  merge lands on the bottom level; tombstones are never dropped.

Failure model: fail-stop with durable media.  Torn manifest writes are
detected by crc and skipped (latest-good wins); a run directory missing
files invalidates exactly the manifests naming it; the WAL tolerates a
torn tail frame.  There is no partial-visibility state: a crashed freeze
either never published (hot tier still owns the data) or published (the
run owns it and the WAL copy is dropped at open).
"""

from repro_torch.core.runfile import RunCorruption

from .cache import BlockCache, default_block_cache, set_default_block_cache
from .compaction import CompactionMetrics, Compactor, LeveledPolicy
from .manifest import Manifest, ManifestCorrupt, ManifestStore, RunInfo
from .store import (StaticRun, StaticWarren, TieredSnapshot, TieredStore,
                    TieredWarren, demote_index, merge_demoted,
                    resurrect_index, split_demoted)

__all__ = [
    "BlockCache", "CompactionMetrics", "Compactor", "LeveledPolicy",
    "Manifest", "ManifestCorrupt", "ManifestStore", "RunCorruption",
    "RunInfo", "StaticRun", "StaticWarren", "TieredSnapshot", "TieredStore",
    "TieredWarren", "default_block_cache", "demote_index", "merge_demoted",
    "resurrect_index", "set_default_block_cache", "split_demoted",
]
