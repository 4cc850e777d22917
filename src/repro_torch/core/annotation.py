"""Annotations and annotation lists under minimal-interval semantics.

An annotation is ``⟨f, (p, q), v⟩``.  The set of annotations for a feature
must form a *generalized concordance list* (GC-list): no interval nests in
another, so the list is strictly increasing in both start and end address.

``reduce_minimal`` implements the paper's ``G(S)`` reduction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

import numpy as np

# Sentinels used by access methods: τ/ρ return (INF, INF, 0) past the end,
# τ'/ρ' return (NINF, NINF, 0) before the beginning.
INF = np.int64(2**62)
NINF = np.int64(-(2**62))


@dataclass(frozen=True)
class Annotation:
    feature: int
    p: int
    q: int
    v: float = 0.0

    def interval(self) -> Tuple[int, int]:
        return (self.p, self.q)


class AnnotationList:
    """Struct-of-arrays GC-list: sorted, non-nesting intervals with values."""

    __slots__ = ("starts", "ends", "values")

    def __init__(self, starts: np.ndarray, ends: np.ndarray, values: np.ndarray,
                 _checked: bool = False):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if not (starts.shape == ends.shape == values.shape):
            raise ValueError("mismatched SoA shapes")
        if not _checked and starts.size:
            if np.any(ends < starts):
                raise ValueError("interval with end < start")
            if np.any(np.diff(starts) <= 0) or np.any(np.diff(ends) <= 0):
                raise ValueError("minimal-interval semantics violated")
        self.starts = starts
        self.ends = ends
        self.values = values

    # ------------------------------------------------------------------ #
    @staticmethod
    def empty() -> "AnnotationList":
        z = np.zeros(0, dtype=np.int64)
        return AnnotationList(z, z, np.zeros(0), _checked=True)

    @staticmethod
    def from_intervals(intervals: Iterable[Tuple[int, int]],
                       values: Iterable[float] = None) -> "AnnotationList":
        ivs = list(intervals)
        vals = list(values) if values is not None else [0.0] * len(ivs)
        if not ivs:
            return AnnotationList.empty()
        s = np.array([i[0] for i in ivs], dtype=np.int64)
        e = np.array([i[1] for i in ivs], dtype=np.int64)
        v = np.array(vals, dtype=np.float64)
        return reduce_minimal(s, e, v)

    def __len__(self) -> int:
        return int(self.starts.size)

    def __iter__(self):
        for i in range(len(self)):
            yield (int(self.starts[i]), int(self.ends[i]), float(self.values[i]))

    def __eq__(self, other) -> bool:
        return (isinstance(other, AnnotationList)
                and np.array_equal(self.starts, other.starts)
                and np.array_equal(self.ends, other.ends)
                and np.array_equal(self.values, other.values))

    def __repr__(self) -> str:
        items = ", ".join(f"({p},{q};{v:g})" for p, q, v in list(self)[:8])
        more = "..." if len(self) > 8 else ""
        return f"AnnotationList[{len(self)}]({items}{more})"

    # --- access methods (paper Eq. 4/5 + backwards variants) ----------- #
    def tau(self, k: int) -> Tuple[int, int, float]:
        """First annotation with start >= k."""
        i = int(np.searchsorted(self.starts, k, side="left"))
        if i >= len(self):
            return (int(INF), int(INF), 0.0)
        return (int(self.starts[i]), int(self.ends[i]), float(self.values[i]))

    def rho(self, k: int) -> Tuple[int, int, float]:
        """First annotation with end >= k."""
        i = int(np.searchsorted(self.ends, k, side="left"))
        if i >= len(self):
            return (int(INF), int(INF), 0.0)
        return (int(self.starts[i]), int(self.ends[i]), float(self.values[i]))

    def tau_b(self, k: int) -> Tuple[int, int, float]:
        """Last annotation with start <= k (backwards τ)."""
        i = int(np.searchsorted(self.starts, k, side="right")) - 1
        if i < 0:
            return (int(NINF), int(NINF), 0.0)
        return (int(self.starts[i]), int(self.ends[i]), float(self.values[i]))

    def rho_b(self, k: int) -> Tuple[int, int, float]:
        """Last annotation with end <= k (backwards ρ)."""
        i = int(np.searchsorted(self.ends, k, side="right")) - 1
        if i < 0:
            return (int(NINF), int(NINF), 0.0)
        return (int(self.starts[i]), int(self.ends[i]), float(self.values[i]))


def reduce_minimal(starts: np.ndarray, ends: np.ndarray,
                   values: np.ndarray = None) -> AnnotationList:
    """G(S): drop intervals that (strictly) contain another interval.

    For duplicate (p, q) pairs the *last* value wins (paper's isolation rule:
    the annotation with the largest sequence number is retained).
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if values is None:
        values = np.zeros(starts.shape, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if starts.size == 0:
        return AnnotationList.empty()
    if np.any(ends < starts):
        raise ValueError("interval with end < start")
    # stable sort by (start asc, end asc); stability keeps insertion order of
    # duplicates so "last wins" is well defined.
    order = np.lexsort((ends, starts))
    s, e, v = starts[order], ends[order], values[order]
    # dedupe exact (p,q): keep the last occurrence in insertion order.  After
    # the stable lexsort, equal (p,q) runs preserve insertion order.
    same = np.concatenate(([False], (s[1:] == s[:-1]) & (e[1:] == e[:-1])))
    keep_last = np.ones(s.size, dtype=bool)
    keep_last[:-1] &= ~same[1:]
    s, e, v = s[keep_last], e[keep_last], v[keep_last]
    # Sorted by (start asc, end asc) with unique (p,q) pairs:
    #  - within an equal-start run, every later interval contains the first
    #    -> keep only the first of each run;
    #  - interval i strictly contains a later-starting interval j>i iff
    #    e[j] <= e[i]  -> keep i only if e[i] < min(e[i+1:]).
    # (Containment witnesses come from the full S, so both tests use the
    # unreduced arrays.)
    suffix_min = np.minimum.accumulate(e[::-1])[::-1]
    keep = np.ones(s.size, dtype=bool)
    keep[1:] &= s[1:] != s[:-1]
    keep[:-1] &= e[:-1] < suffix_min[1:]
    return AnnotationList(s[keep], e[keep], v[keep], _checked=True)


def union_intervals(lists: Iterable[AnnotationList]) -> AnnotationList:
    """Coalescing union of interval lists (for *erased* sets, not GC-lists).

    Erasure is permanent over a point-set of addresses, so erased intervals
    must accumulate as a union: overlapping, nested, and adjacent intervals
    coalesce instead of competing under minimal-interval reduction (where a
    nested erase would *drop* its enclosing interval and un-hide content).
    The result is a sorted, disjoint interval list — a valid GC-list — with
    all values zero.
    """
    ls = [l for l in lists if len(l)]
    if not ls:
        return AnnotationList.empty()
    s = np.concatenate([l.starts for l in ls])
    e = np.concatenate([l.ends for l in ls])
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    # sweep: start a new interval only where the gap to the running
    # coalesced end is >= 2 (adjacent intervals merge: erased is a point-set)
    run_end = np.maximum.accumulate(e)
    new_run = np.ones(s.size, dtype=bool)
    new_run[1:] = s[1:] > run_end[:-1] + 1
    starts = s[new_run]
    idx = np.flatnonzero(new_run)
    bounds = np.append(idx[1:], s.size)
    ends = run_end[bounds - 1]
    return AnnotationList(starts, ends, np.zeros(starts.size), _checked=True)


def merge_lists(lists: Iterable[AnnotationList]) -> AnnotationList:
    """Merge GC-lists from multiple index segments into one GC-list.

    Nesting conflicts keep the innermost annotation (paper §5); exact
    duplicates keep the one from the latest segment (largest seqnum), so pass
    segments in sequence order.
    """
    ls = [l for l in lists if len(l)]
    if not ls:
        return AnnotationList.empty()
    if len(ls) == 1:
        return ls[0]
    s = np.concatenate([l.starts for l in ls])
    e = np.concatenate([l.ends for l in ls])
    v = np.concatenate([l.values for l in ls])
    return reduce_minimal(s, e, v)
