"""Lazy GCL operator algebra under minimal-interval semantics (paper Fig. 2).

Every node supports four access methods over its (conceptual) solution list:

  tau(k)    first solution with start >= k
  rho(k)    first solution with end   >= k
  tau_b(k)  last  solution with start <= k   ("backwards" τ, Clarke 1996)
  rho_b(k)  last  solution with end   <= k   ("backwards" ρ)

All return ``(p, q, v)`` with ``(INF, INF, 0)`` / ``(NINF, NINF, 0)``
sentinels.  Operator access methods are written in terms of their children's
access methods only, so evaluation is lazy and solutions to subqueries that
cannot contribute are skipped (the WAND-like behaviour the paper describes).
Each failed probe advances a child cursor by a *proved-safe* skip, giving the
O(n · A · log(L/A)) bound of Clarke & Cormack (2000) when the leaf access
methods use galloping search.

This module is the lazy host engine, kept identical to the reference
package's; ``core/vectorized.py`` re-derives the same algebra as batched
tensor programs for the card, and the tests hold both against the
reference package and a brute-force oracle.
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

    # Operator sugar mirroring Fig. 2 --------------------------------- #
    def contained_in(self, other: "GCLNode") -> "GCLNode":
        return ContainedIn(self, other)

    def containing(self, other: "GCLNode") -> "GCLNode":
        return Containing(self, other)

    def not_contained_in(self, other: "GCLNode") -> "GCLNode":
        return NotContainedIn(self, other)

    def not_containing(self, other: "GCLNode") -> "GCLNode":
        return NotContaining(self, other)

    def both_of(self, other: "GCLNode") -> "GCLNode":
        return BothOf(self, other)

    def one_of(self, other: "GCLNode") -> "GCLNode":
        return OneOf(self, other)

    def followed_by(self, other: "GCLNode") -> "GCLNode":
        return FollowedBy(self, other)

    __and__ = both_of
    __or__ = one_of
    __rshift__ = followed_by
    __lt__ = contained_in
    __gt__ = containing


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


class _Binary(GCLNode):
    def __init__(self, a: GCLNode, b: GCLNode):
        self.a = a
        self.b = b


class _CombinationBase(_Binary):
    """Combination operators (△ ▽ ◇) synthesize intervals, so only τ and ρ'
    admit direct constructions: a candidate for ρ(k) could contain a minimal
    solution whose end lies *below* k (resp. τ' and starts above k), which no
    bounded probe of the children can rule out.  Because the solution list
    strictly increases in both start and end, the remaining two methods are
    exact successor/predecessor hops:

        ρ(k)  = successor(ρ'(k-1))  = τ(ρ'(k-1).start + 1)
        τ'(k) = predecessor(τ(k+1)) = ρ'(τ(k+1).end - 1)
    """

    def rho(self, k: int) -> Result:
        r = self.rho_b(k - 1)
        if _is_ninf(r):
            return self.tau(int(NINF) + 1)
        return self.tau(r[0] + 1)

    def tau_b(self, k: int) -> Result:
        t = self.tau(k + 1)
        if _is_inf(t):
            return self.rho_b(int(INF) - 1)
        return self.rho_b(t[1] - 1)


class ContainedIn(_Binary):
    """A ⊲ B: annotations of A contained in some annotation of B."""

    def _scan(self, a: Result) -> Result:
        A, B = self.a, self.b
        while not _is_inf(a):
            b = B.rho(a[1])           # first b ending >= a.q
            if _is_inf(b):
                return _INF_T
            if b[0] <= a[0]:          # b contains a
                return a
            a = A.tau(b[0])           # safe skip: a container must start <= a.p
        return _INF_T

    def tau(self, k: int) -> Result:
        return self._scan(self.a.tau(k))

    def rho(self, k: int) -> Result:
        return self._scan(self.a.rho(k))

    def _scan_b(self, a: Result) -> Result:
        A, B = self.a, self.b
        while not _is_ninf(a):
            b = B.tau_b(a[0])         # last b starting <= a.p
            if _is_ninf(b):
                return _NINF_T
            if b[1] >= a[1]:          # b contains a
                return a
            a = A.rho_b(b[1])         # safe skip backwards
        return _NINF_T

    def tau_b(self, k: int) -> Result:
        return self._scan_b(self.a.tau_b(k))

    def rho_b(self, k: int) -> Result:
        return self._scan_b(self.a.rho_b(k))


class Containing(_Binary):
    """A ⊳ B: annotations of A containing some annotation of B."""

    def _scan(self, a: Result) -> Result:
        A, B = self.a, self.b
        while not _is_inf(a):
            b = B.tau(a[0])           # first b starting >= a.p
            if _is_inf(b):
                return _INF_T
            if b[1] <= a[1]:          # a contains b
                return a
            a = A.rho(b[1])           # safe skip: a must end >= b.q
        return _INF_T

    def tau(self, k: int) -> Result:
        return self._scan(self.a.tau(k))

    def rho(self, k: int) -> Result:
        return self._scan(self.a.rho(k))

    def _scan_b(self, a: Result) -> Result:
        A, B = self.a, self.b
        while not _is_ninf(a):
            b = B.rho_b(a[1])         # last b ending <= a.q
            if _is_ninf(b):
                return _NINF_T
            if b[0] >= a[0]:          # a contains b
                return a
            a = A.tau_b(b[0])
        return _NINF_T

    def tau_b(self, k: int) -> Result:
        return self._scan_b(self.a.tau_b(k))

    def rho_b(self, k: int) -> Result:
        return self._scan_b(self.a.rho_b(k))


class NotContainedIn(_Binary):
    """A ⋪ B: annotations of A not contained in any annotation of B."""

    def _ok(self, a: Result) -> bool:
        b = self.b.rho(a[1])
        return _is_inf(b) or b[0] > a[0]

    def tau(self, k: int) -> Result:
        a = self.a.tau(k)
        while not _is_inf(a) and not self._ok(a):
            a = self.a.tau(a[0] + 1)
        return a

    def rho(self, k: int) -> Result:
        a = self.a.rho(k)
        while not _is_inf(a) and not self._ok(a):
            a = self.a.tau(a[0] + 1)
        return a

    def tau_b(self, k: int) -> Result:
        a = self.a.tau_b(k)
        while not _is_ninf(a) and not self._ok(a):
            a = self.a.tau_b(a[0] - 1)
        return a

    def rho_b(self, k: int) -> Result:
        a = self.a.rho_b(k)
        while not _is_ninf(a) and not self._ok(a):
            a = self.a.tau_b(a[0] - 1)
        return a


class NotContaining(_Binary):
    """A ⋫ B: annotations of A not containing any annotation of B."""

    def _ok(self, a: Result) -> bool:
        b = self.b.tau(a[0])
        return _is_inf(b) or b[1] > a[1]

    def tau(self, k: int) -> Result:
        a = self.a.tau(k)
        while not _is_inf(a) and not self._ok(a):
            a = self.a.tau(a[0] + 1)
        return a

    def rho(self, k: int) -> Result:
        a = self.a.rho(k)
        while not _is_inf(a) and not self._ok(a):
            a = self.a.tau(a[0] + 1)
        return a

    def tau_b(self, k: int) -> Result:
        a = self.a.tau_b(k)
        while not _is_ninf(a) and not self._ok(a):
            a = self.a.tau_b(a[0] - 1)
        return a

    def rho_b(self, k: int) -> Result:
        a = self.a.rho_b(k)
        while not _is_ninf(a) and not self._ok(a):
            a = self.a.tau_b(a[0] - 1)
        return a


class BothOf(_CombinationBase):
    """A △ B: minimal intervals containing one annotation of each."""

    def tau(self, k: int) -> Result:
        a = self.a.tau(k)
        b = self.b.tau(k)
        if _is_inf(a) or _is_inf(b):
            return _INF_T
        v = max(a[1], b[1])                      # minimal end, both starts >= k
        ra = self.a.rho_b(v)                     # maximize start for this end
        rb = self.b.rho_b(v)
        return (min(ra[0], rb[0]), v, 0.0)

    def rho_b(self, k: int) -> Result:
        a = self.a.rho_b(k)
        b = self.b.rho_b(k)
        if _is_ninf(a) or _is_ninf(b):
            return _NINF_T
        u = min(a[0], b[0])                      # maximal start, both ends <= k
        ta = self.a.tau(u)                       # minimize end for this start
        tb = self.b.tau(u)
        return (u, max(ta[1], tb[1]), 0.0)


class OneOf(_CombinationBase):
    """A ▽ B: G(A ∪ B) — merge with nesting elimination."""

    def tau(self, k: int) -> Result:
        a = self.a.tau(k)
        b = self.b.tau(k)
        while True:
            if _is_inf(a):
                return b
            if _is_inf(b):
                return a
            if a[0] == b[0] and a[1] == b[1]:
                return a
            if a[0] <= b[0] and b[1] <= a[1]:    # b nests (strictly) in a
                a = self.a.tau(a[0] + 1)
            elif b[0] <= a[0] and a[1] <= b[1]:  # a nests in b
                b = self.b.tau(b[0] + 1)
            else:
                return a if a[0] < b[0] else b

    def rho_b(self, k: int) -> Result:
        a = self.a.rho_b(k)
        b = self.b.rho_b(k)
        while True:
            if _is_ninf(a):
                return b
            if _is_ninf(b):
                return a
            if a[0] == b[0] and a[1] == b[1]:
                return a
            if a[0] <= b[0] and b[1] <= a[1]:
                a = self.a.rho_b(a[1] - 1)
            elif b[0] <= a[0] and a[1] <= b[1]:
                b = self.b.rho_b(b[1] - 1)
            else:
                return a if a[1] > b[1] else b


class FollowedBy(_CombinationBase):
    """A ◇ B: minimal intervals covering an A-annotation strictly followed by
    a B-annotation."""

    def tau(self, k: int) -> Result:
        a = self.a.tau(k)
        if _is_inf(a):
            return _INF_T
        b = self.b.tau(a[1] + 1)
        if _is_inf(b):
            return _INF_T
        a2 = self.a.rho_b(b[0] - 1)              # maximize start (a exists)
        return (a2[0], b[1], 0.0)

    def rho_b(self, k: int) -> Result:
        b = self.b.rho_b(k)
        if _is_ninf(b):
            return _NINF_T
        a = self.a.rho_b(b[0] - 1)
        if _is_ninf(a):
            return _NINF_T
        b2 = self.b.tau(a[1] + 1)                # minimize end (b exists)
        return (a[0], b2[1], 0.0)


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


def one_of_all(nodes: Sequence[GCLNode]) -> GCLNode:
    """Balanced ▽-tree over many nodes (e.g. query-term merge)."""
    nodes = list(nodes)
    if not nodes:
        return Term(AnnotationList.empty())
    while len(nodes) > 1:
        nodes = [OneOf(nodes[i], nodes[i + 1]) if i + 1 < len(nodes) else nodes[i]
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def both_of_all(nodes: Sequence[GCLNode]) -> GCLNode:
    nodes = list(nodes)
    if not nodes:
        return Term(AnnotationList.empty())
    while len(nodes) > 1:
        nodes = [BothOf(nodes[i], nodes[i + 1]) if i + 1 < len(nodes) else nodes[i]
                 for i in range(0, len(nodes), 2)]
    return nodes[0]
