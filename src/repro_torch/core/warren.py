"""Warren: groups components and manages transactions (paper Fig. 3).

A Warren exposes exactly the paper's operations:

  clone, start, end, transaction, ready, commit, abort      (lifecycle)
  hopper(f)      — Idx: cursor over a feature's annotation list
  translate(p,q) — Txt: T(p, q)
  append / annotate / erase — Appender/Annotator (inside a transaction)

Each clone manages at most one transaction at a time; any access, even
read-only, must be bracketed by start/end.  Updates become visible only
after end() followed by another start().
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .annotation import AnnotationList
from .gcl import GCLNode, Phrase, Term
from .index import DynamicIndex, Snapshot, Transaction


class Warren:
    def __init__(self, index: DynamicIndex):
        self.index = index
        self._snapshot: Optional[Snapshot] = None
        self._txn: Optional[Transaction] = None

    # -- lifecycle ------------------------------------------------------ #
    def clone(self) -> "Warren":
        return Warren(self.index)

    def start(self) -> None:
        if self._snapshot is not None:
            raise RuntimeError("already started")
        self._snapshot = self.index.snapshot()

    def end(self) -> None:
        self._snapshot = None

    def __enter__(self) -> "Warren":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        if self._txn is not None and self._txn._state in ("open", "ready"):
            self._txn.abort()
            self._txn = None
        self.end()
        return False

    # -- transactions ---------------------------------------------------- #
    def transaction(self) -> None:
        self._require_started()
        if self._txn is not None:
            raise RuntimeError("transaction already active on this warren")
        self._txn = self.index.transaction()

    def append(self, text: str) -> Tuple[int, int]:
        return self._require_txn().append(text)

    def annotate(self, feature, p: int, q: int, v: float = 0.0,
                 v_is_address: bool = False) -> None:
        self._require_txn().annotate(feature, p, q, v, v_is_address=v_is_address)

    def erase(self, p: int, q: int) -> None:
        self._require_txn().erase(p, q)

    def ready(self) -> None:
        self._require_txn().ready()

    def commit(self):
        """Commit; returns the staging→permanent address remap function."""
        txn = self._require_txn()
        txn.commit()
        self._txn = None
        return txn.remap

    def abort(self) -> None:
        self._require_txn().abort()
        self._txn = None

    # -- reads ------------------------------------------------------------ #
    def featurize(self, feature: str) -> int:
        return self.index.featurizer.featurize(feature)

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
        """Query helper: tokenize text, AND-adjacent tokens into a Phrase."""
        self._require_started()
        words = self.index.tokenizer.split(text)
        terms = [self.hopper(w) for w in words]
        if not terms:
            return Term(AnnotationList.empty())
        if len(terms) == 1:
            return terms[0]
        return Phrase(terms)

    # -- internals ---------------------------------------------------------- #
    def _require_started(self) -> None:
        if self._snapshot is None:
            raise RuntimeError("warren access outside start()/end()")

    def _require_txn(self) -> Transaction:
        if self._txn is None:
            raise RuntimeError("no active transaction")
        return self._txn
