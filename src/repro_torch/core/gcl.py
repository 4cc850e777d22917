"""Lazy GCL leaves under minimal-interval semantics (paper Fig. 2).

Every node supports four access methods over its (conceptual) solution list:

  tau(k)    first solution with start >= k
  rho(k)    first solution with end   >= k
  tau_b(k)  last  solution with start <= k   ("backwards" τ, Clarke 1996)
  rho_b(k)  last  solution with end   <= k   ("backwards" ρ)

All return ``(p, q, v)`` with ``(INF, INF, 0)`` / ``(NINF, NINF, 0)``
sentinels.  This module holds what the index and the warren hand out: the
base node, the galloping :class:`Term` cursor (the paper's Hopper) and the
:class:`Phrase` adjacency operator.  The containment and combination
operators are not part of this package yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .annotation import INF, NINF, AnnotationList

Result = Tuple[int, int, float]
_INF_T: Result = (int(INF), int(INF), 0.0)
_NINF_T: Result = (int(NINF), int(NINF), 0.0)


def _is_inf(t: Result) -> bool:
    return t[1] >= INF


def _is_ninf(t: Result) -> bool:
    return t[0] <= NINF


class GCLNode:
    """Base class: a lazily evaluated GC-list."""

    def tau(self, k: int) -> Result:
        raise NotImplementedError

    def rho(self, k: int) -> Result:
        raise NotImplementedError

    def tau_b(self, k: int) -> Result:
        raise NotImplementedError

    def rho_b(self, k: int) -> Result:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def solutions(self, lo: int = None, hi: int = None) -> List[Result]:
        """All minimal solutions, optionally restricted to [lo, hi]."""
        out: List[Result] = []
        k = int(NINF) + 1 if lo is None else lo
        t = self.tau(k)
        while not _is_inf(t) and (hi is None or t[1] <= hi):
            out.append(t)
            t = self.tau(t[0] + 1)
        return out

    def solutions_disjoint(self, lo: int = None, hi: int = None) -> List[Result]:
        """The paper's Solve(Q) loop: successive τ(q + 1), disjoint witnesses."""
        out: List[Result] = []
        k = int(NINF) + 1 if lo is None else lo
        t = self.tau(k)
        while not _is_inf(t) and (hi is None or t[1] <= hi):
            out.append(t)
            t = self.tau(t[1] + 1)
        return out

    def to_list(self) -> AnnotationList:
        sols = self.solutions()
        return AnnotationList.from_intervals([(p, q) for p, q, _ in sols],
                                             [v for _, _, v in sols])


class Term(GCLNode):
    """Leaf node over a materialized annotation list.

    Maintains a cached cursor per access method and *gallops* from the cached
    position (Büttcher et al. 2010, pp. 42-44) so a sequence of increasing
    probes costs O(log gap) each rather than O(log L).
    """

    def __init__(self, annotations: AnnotationList):
        self.list = annotations
        self._n = len(annotations)
        self._cache = {"tau": 0, "rho": 0, "tau_b": self._n - 1, "rho_b": self._n - 1}

    def _at(self, i: int) -> Result:
        l = self.list
        return (int(l.starts[i]), int(l.ends[i]), float(l.values[i]))

    def _gallop_ge(self, arr, k: int, hint: int) -> int:
        """Smallest i with arr[i] >= k, galloping from hint."""
        n = self._n
        if hint >= n:
            hint = n - 1
        if hint < 0:
            hint = 0
        if arr[hint] >= k:
            # gallop left
            step, hi = 1, hint
            lo = hint - 1
            while lo >= 0 and arr[lo] >= k:
                hi = lo
                lo -= step
                step <<= 1
            lo = max(lo, -1)
        else:
            # gallop right
            step, lo = 1, hint
            hi = hint + 1
            while hi < n and arr[hi] < k:
                lo = hi
                hi += step
                step <<= 1
            hi = min(hi, n)
            if hi == n:
                # arr[n-1] may still be < k
                if arr[n - 1] < k:
                    return n
        # binary search in (lo, hi]: arr[lo] < k <= arr[hi]
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if arr[mid] >= k:
                hi = mid
            else:
                lo = mid
        return hi

    def tau(self, k: int) -> Result:
        if self._n == 0:
            return _INF_T
        i = self._gallop_ge(self.list.starts, k, self._cache["tau"])
        self._cache["tau"] = i
        return _INF_T if i >= self._n else self._at(i)

    def rho(self, k: int) -> Result:
        if self._n == 0:
            return _INF_T
        i = self._gallop_ge(self.list.ends, k, self._cache["rho"])
        self._cache["rho"] = i
        return _INF_T if i >= self._n else self._at(i)

    def tau_b(self, k: int) -> Result:
        if self._n == 0:
            return _NINF_T
        i = self._gallop_ge(self.list.starts, k + 1, self._cache["tau_b"]) - 1
        self._cache["tau_b"] = max(i, 0)
        return _NINF_T if i < 0 else self._at(i)

    def rho_b(self, k: int) -> Result:
        if self._n == 0:
            return _NINF_T
        i = self._gallop_ge(self.list.ends, k + 1, self._cache["rho_b"]) - 1
        self._cache["rho_b"] = max(i, 0)
        return _NINF_T if i < 0 else self._at(i)


class Phrase(GCLNode):
    """Fixed adjacency over singleton token lists: t₀ t₁ … tₙ₋₁."""

    def __init__(self, terms: Sequence[GCLNode]):
        if not terms:
            raise ValueError("empty phrase")
        self.terms = list(terms)

    def _match_at(self, k: int) -> Result:
        """First phrase occurrence with start >= k."""
        n = len(self.terms)
        while True:
            t0 = self.terms[0].tau(k)
            if _is_inf(t0):
                return _INF_T
            p = t0[0]
            restart = None
            for i in range(1, n):
                ti = self.terms[i].tau(p + i)
                if _is_inf(ti):
                    return _INF_T
                if ti[0] != p + i:
                    restart = ti[0] - i  # earliest start that could align tᵢ
                    break
            if restart is None:
                return (p, p + n - 1, 0.0)
            k = max(restart, p + 1)

    def tau(self, k: int) -> Result:
        return self._match_at(k)

    def rho(self, k: int) -> Result:
        return self._match_at(k - len(self.terms) + 1)

    def _match_at_b(self, k: int) -> Result:
        """Last phrase occurrence with start <= k."""
        n = len(self.terms)
        while True:
            t0 = self.terms[0].tau_b(k)
            if _is_ninf(t0):
                return _NINF_T
            p = t0[0]
            restart = None
            for i in range(1, n):
                ti = self.terms[i].tau_b(p + i)
                if _is_ninf(ti):
                    return _NINF_T
                if ti[0] != p + i:
                    restart = ti[0] - i
                    break
            if restart is None:
                return (p, p + n - 1, 0.0)
            k = min(restart, p - 1)

    def tau_b(self, k: int) -> Result:
        return self._match_at_b(k)

    def rho_b(self, k: int) -> Result:
        return self._match_at_b(k - len(self.terms) + 1)
