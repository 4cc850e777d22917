"""Content storage and the translation function T(p, q).

Content is a sequence of tokens situated in a global address space (paper
Fig. 1).  Each ``append`` contributes one record: a contiguous run of token
addresses plus the original text and per-token character offsets, so
``translate`` reproduces the *original* text span (including separators)
between the first and last token of the interval.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class AppendRecord:
    lo: int                 # first token address
    hi: int                 # last token address (inclusive)
    text: str               # original appended text
    offsets: np.ndarray     # [n_tokens, 2] char (offset, length)
    tokens: Tuple[str, ...] # token strings (content addressing)


class ContentStore:
    """Ordered, non-overlapping append records (one per ``append`` call)."""

    def __init__(self):
        self._records: List[AppendRecord] = []
        self._los: List[int] = []

    def add(self, record: AppendRecord) -> None:
        if self._los and record.lo <= self._records[-1].hi:
            raise ValueError("append records must be address-ordered")
        self._records.append(record)
        self._los.append(record.lo)

    def records(self) -> Sequence[AppendRecord]:
        return self._records

    def _covering(self, p: int, q: int) -> Optional[List[AppendRecord]]:
        """Records covering [p, q] with no address gap, else None."""
        if not self._records or q < p:
            return None
        i = bisect.bisect_right(self._los, p) - 1
        if i < 0:
            return None
        out: List[AppendRecord] = []
        expect = p
        while expect <= q:
            if i >= len(self._records):
                return None
            r = self._records[i]
            if not (r.lo <= expect <= r.hi):
                return None
            out.append(r)
            expect = r.hi + 1
            i += 1
        return out

    def translate(self, p: int, q: int) -> Optional[str]:
        """T(p, q): original text spanning token addresses [p, q]."""
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

    def span(self) -> Tuple[int, int]:
        if not self._records:
            return (0, -1)
        return (self._records[0].lo, self._records[-1].hi)
