"""Runtime lock witness — lockdep for the warren's ProfiledLocks.

The static lock analysis proves ordering over the
acquisition graph it can *see*; the witness covers what static analysis
cannot — aliasing, dynamic dispatch, config-dependent paths — by
recording the per-thread acquisition order actually observed while the
tier-1 / stress suites (``REPRO_LOCK_WITNESS=1``) or the
day-in-the-life bench run.

Checks, per acquisition, against everything the thread already holds:

* **hierarchy** — an acquisition violating the declared rank order of
  ``analysis/lock_hierarchy.toml``;
* **cycle** — an observed edge ``A→B`` when ``B→…→A`` was already
  observed (the classic AB/BA inversion, across any two threads' whole
  history — neither thread has to actually deadlock for the witness to
  catch it);
* **ascending order** — two instances of an ``ascending`` lock class
  (the group-write rule) taken with a non-increasing order key;
* **same-class nesting** — two *instances* of a single-instance lock
  class nested (rank order cannot disambiguate them).

Violations are recorded, not raised mid-acquire (raising inside a lock
acquisition would corrupt the caller's unwind); the harness calls
:meth:`LockWitness.check` at teardown and fails the run.

Overhead: when no witness is installed, each ProfiledLock operation
pays one module-attribute load + ``is None`` test.  When installed, the
fast path is a thread-local list walk (typically 0–2 held frames) and
one dict lookup for an already-seen edge; graph mutation takes a lock
only for *never-seen* edges, which dry up after warmup.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

class LockOrderViolation(AssertionError):
    """Raised by :meth:`LockWitness.check` when any violation was seen."""


class LockWitness:
    def __init__(self, ranks: Optional[Dict[str, int]] = None,
                 multi: Optional[Dict[str, str]] = None):
        self._ranks = dict(ranks or {})
        self._multi = dict(multi or {})
        # (src, dst) -> first-observed provenance "thread:src->dst"
        self._edges: Dict[Tuple[str, str], str] = {}
        self._graph: Dict[str, List[str]] = {}
        self._violations: List[str] = []
        self._mu = threading.Lock()
        self._tls = threading.local()

    # -- configuration ----------------------------------------------------- #
    @classmethod
    def from_hierarchy(cls, path: str) -> "LockWitness":
        """Build from ``analysis/lock_hierarchy.toml``, read by the
        port's own copy of the hierarchy reader (:mod:`.hierarchy`)."""
        from .hierarchy import Hierarchy
        h = Hierarchy.load(path)
        return cls(ranks={n: l.rank for n, l in h.levels.items()},
                   multi={n: l.multi for n, l in h.levels.items()})

    # -- per-thread state --------------------------------------------------- #
    def _stack(self) -> List[Tuple[str, Optional[int], int]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- the hooks ---------------------------------------------------------- #
    def _note_acquire_impl(self, name: str, order_key: Optional[int],
                           inst: int) -> None:
        st = self._stack()
        if any(f[2] == inst for f in st):
            # same instance re-entered (RLock) — ordering already decided
            st.append((name, order_key, inst))
            return
        tname = threading.current_thread().name
        for held_name, held_key, _ in st:
            if held_name == name:
                mode = self._multi.get(name, "none")
                if mode == "ascending":
                    if (order_key is not None and held_key is not None
                            and order_key <= held_key):
                        self._record(
                            f"ascending-order: {name!r} key {order_key} "
                            f"acquired after key {held_key} in thread "
                            f"{tname} — the ascending rule requires "
                            f"strictly increasing order keys")
                elif mode == "none":
                    self._record(
                        f"same-class-nesting: two instances of "
                        f"single-instance lock {name!r} nested in thread "
                        f"{tname}")
                continue
            self._edge(held_name, name, tname)
        st.append((name, order_key, inst))
    note_acquire = _note_acquire_impl   # see the _impl note

    def _note_release_impl(self, name: str, inst: int) -> None:
        st = getattr(self._tls, "stack", None)
        if not st:
            return
        for i in range(len(st) - 1, -1, -1):
            if st[i][2] == inst:
                del st[i]
                return
    note_release = _note_release_impl   # see the _impl note

    # -- graph -------------------------------------------------------------- #
    def _edge(self, a: str, b: str, tname: str) -> None:
        if (a, b) in self._edges:        # fast path: known-good edge
            return
        with self._mu:
            if (a, b) in self._edges:
                return
            ra, rb = self._ranks.get(a), self._ranks.get(b)
            if ra is not None and rb is not None and ra > rb:
                self._record_locked(
                    f"hierarchy: {b!r} (rank {rb}) acquired while {a!r} "
                    f"(rank {ra}) held in thread {tname} — declared "
                    f"order inverted")
            if self._reachable(b, a):
                self._record_locked(
                    f"cycle: observed {a!r}→{b!r} closes a cycle with "
                    f"the already-observed {b!r}→…→{a!r} (thread "
                    f"{tname}) — AB/BA inversion")
            self._edges[(a, b)] = tname
            self._graph.setdefault(a, []).append(b)

    def _reachable(self, src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            nxt = []
            for n in frontier:
                for m in self._graph.get(n, ()):
                    if m == dst:
                        return True
                    if m not in seen:
                        seen.add(m)
                        nxt.append(m)
            frontier = nxt
        return False

    # -- violations --------------------------------------------------------- #
    def _record(self, msg: str) -> None:
        with self._mu:
            self._record_locked(msg)

    def _record_locked(self, msg: str) -> None:
        if len(self._violations) < 100:
            self._violations.append(msg)

    def violations(self) -> List[str]:
        with self._mu:
            return list(self._violations)

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def check(self) -> None:
        """Raise :class:`LockOrderViolation` if anything was observed."""
        v = self.violations()
        if v:
            raise LockOrderViolation(
                f"{len(v)} lock-order violation(s) observed:\n  "
                + "\n  ".join(v))


# --------------------------------------------------------------------- #
# process-global installation
# --------------------------------------------------------------------- #
_active: Optional[LockWitness] = None


def install(witness: Optional[LockWitness] = None) -> LockWitness:
    """Install (and return) the process-global witness.  ProfiledLocks
    start reporting to it immediately."""
    global _active
    if witness is None:
        witness = LockWitness()
    _active = witness
    return witness


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[LockWitness]:
    return _active
