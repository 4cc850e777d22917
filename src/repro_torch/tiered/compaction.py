"""Background compaction for the tiered store.

The :class:`Compactor` runs freeze/compact maintenance on its own thread:

  * when the hot tier accumulates ``freeze_segments`` committed segments
    (or ``freeze_records`` content records), it is frozen into a new L0 run
    — which first triggers the hot tier's size-tiered segment auto-merge,
    so run writes stay one-segment cheap;
  * runs are folded down **leveled**: freshly frozen runs pile up at L0;
    when L0 reaches :attr:`LeveledPolicy.l0_trigger` every L0 run (plus the
    L1 runs its address range overlaps) merges into one L1 run; a deeper
    level whose total bytes exceed its geometric target sheds its
    least-overlapping run into the next level.  Erased content records are
    GC'd only when the output lands on the bottom level — upper-level
    merges defer the reclaim, classic leveled doctrine (Munro et al.,
    PAPERS.md).  Tombstones themselves are never dropped (annotative
    semantics: later transactions may annotate erased ranges).

Readers never block: they pin a (runs, hot-snapshot) view; the only
mutual-exclusion window is the view swap, whose duration is recorded in
:class:`CompactionMetrics` as pause time (the LSM "write stall" figure the
``benchmarks/build_throughput.py --tiered`` mode reports).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs

from .manifest import RunInfo


@dataclass(frozen=True)
class LeveledPolicy:
    """Leveled, overlap-aware compaction targets.

    ``l0_trigger`` L0 runs force an L0→L1 fold (all of L0 — L0 runs
    overlap by construction, so partial folds would corrupt recency);
    level ``i >= 1`` holds up to ``base_bytes * ratio**(i-1)`` bytes, and
    an over-target level sheds the run with the *least* byte-overlap into
    ``i+1`` (minimizing write amplification), expanded to the closure of
    next-level runs its address range overlaps so within-level runs stay
    address-disjoint.
    """

    l0_trigger: int = 4
    base_bytes: int = 4 * 1024 * 1024
    ratio: int = 8
    max_level: int = 6

    def target_bytes(self, level: int) -> int:
        return self.base_bytes * (self.ratio ** max(0, level - 1))

    @staticmethod
    def _overlaps(a: RunInfo, lo: int, hi: int) -> bool:
        return a.addr_lo <= hi and lo <= a.addr_hi

    @classmethod
    def _closure(cls, victims: List[RunInfo],
                 next_level: Sequence[RunInfo]) -> List[RunInfo]:
        """Expand ``victims`` with every next-level run overlapping their
        combined address range, to a fixpoint (adding a run widens the
        range, which can overlap further adjacent runs)."""
        out = list(victims)
        pool = [r for r in next_level]
        changed = True
        while changed:
            changed = False
            lo = min(r.addr_lo for r in out)
            hi = max(r.addr_hi for r in out)
            for r in list(pool):
                if cls._overlaps(r, lo, hi):
                    out.append(r)
                    pool.remove(r)
                    changed = True
        return out

    def pick(self, infos: Sequence[RunInfo]
             ) -> Optional[Tuple[List[RunInfo], int]]:
        """Choose a compaction: ``(victims, output_level)`` or None.

        ``victims`` come back merge-ordered (deepest level first, then
        ascending sequence) so the k-way merge preserves recency on exact
        interval ties."""
        by_level: Dict[int, List[RunInfo]] = {}
        for i in infos:
            by_level.setdefault(i.level, []).append(i)
        chosen: Optional[List[RunInfo]] = None
        out_level = 0
        l0 = by_level.get(0, [])
        if len(l0) >= self.l0_trigger:
            chosen = self._closure(list(l0), by_level.get(1, []))
            out_level = 1
        else:
            for level in sorted(k for k in by_level if k >= 1):
                if level >= self.max_level:
                    continue
                runs = by_level[level]
                if sum(r.nbytes for r in runs) <= self.target_bytes(level):
                    continue
                nxt = by_level.get(level + 1, [])

                def overlap_bytes(r: RunInfo) -> int:
                    return sum(n.nbytes for n in nxt
                               if self._overlaps(n, r.addr_lo, r.addr_hi))

                victim = min(runs, key=lambda r: (overlap_bytes(r),
                                                  r.seq_lo, r.run_id))
                chosen = self._closure([victim], nxt)
                out_level = level + 1
                break
        if chosen is None or len(chosen) < 1:
            return None
        if len(chosen) == 1 and chosen[0].level == out_level:
            return None                    # nothing would change
        chosen.sort(key=lambda i: (-i.level, i.seq_lo, i.run_id))
        return chosen, out_level


@dataclass
class CompactionMetrics:
    """Counters + pause samples, shared by manual and background paths.

    Pause samples also feed the ``compaction_pause_ms{kind}`` registry
    histogram, so the LSM write-stall distribution shows up next to the
    serving percentiles in every snapshot."""
    n_freezes: int = 0
    n_merges: int = 0
    pause_s: List[float] = field(default_factory=list)

    def note_freeze(self, pause: float) -> None:
        self.n_freezes += 1
        self.pause_s.append(pause)
        self._observe("freeze", pause)

    def note_merge(self, pause: float) -> None:
        self.n_merges += 1
        self.pause_s.append(pause)
        self._observe("merge", pause)

    @staticmethod
    def _observe(kind: str, pause: float) -> None:
        reg = obs.registry()
        if reg.enabled:
            reg.histogram("compaction_pause_ms",
                          "reader-visible view-swap stall per freeze/merge",
                          kind=kind).observe(1e3 * pause)

    @property
    def total_pause_s(self) -> float:
        return float(sum(self.pause_s))

    @property
    def max_pause_s(self) -> float:
        return float(max(self.pause_s, default=0.0))

    def summary(self) -> str:
        return (f"{self.n_freezes} freezes, {self.n_merges} merges, "
                f"pause total {1e3 * self.total_pause_s:.2f} ms, "
                f"max {1e3 * self.max_pause_s:.3f} ms")


class Compactor:
    """Background freeze + leveled-compaction loop over one
    :class:`TieredStore`.  ``max_runs`` doubles as the L0 trigger when no
    explicit :class:`LeveledPolicy` is given (back-compat with the old
    full-merge knob)."""

    def __init__(self, store, freeze_segments: int = 4,
                 freeze_records: int = 4096, max_runs: int = 4,
                 interval_s: float = 0.05,
                 policy: Optional[LeveledPolicy] = None):
        self.store = store
        self.freeze_segments = freeze_segments
        self.freeze_records = freeze_records
        self.max_runs = max_runs
        self.policy = policy or LeveledPolicy(l0_trigger=max(2, max_runs))
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread = None

    # -- policy ----------------------------------------------------------- #
    def _hot_pressure(self) -> bool:
        hot = self.store.hot
        with hot._publish_lock:
            segs = hot._segments
        if len(segs) >= self.freeze_segments:
            return True
        return sum(len(s.content.records()) for s in segs) \
            >= self.freeze_records

    def run_once(self) -> bool:
        """One maintenance pass; returns True when any work was done."""
        did = False
        if self._hot_pressure():
            did = self.store.freeze() is not None
        did = self.store.compact_level(self.policy) is not None or did
        return did

    # -- thread ----------------------------------------------------------- #
    def start(self) -> "Compactor":
        if self._thread is not None:
            raise RuntimeError("compactor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tiered-compactor")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception:   # pragma: no cover - keep the loop alive
                import traceback
                traceback.print_exc()

    def stop(self, drain: bool = True) -> None:
        """Stop the thread; with ``drain`` run one final freeze plus a full
        bottom-level merge so the on-disk state reflects everything
        committed in one GC'd run."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if drain:
            self.store.freeze()
            if self.store.n_runs > self.max_runs:
                self.store.compact_runs()
