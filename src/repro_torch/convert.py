"""Carry committed index state across: segment records → a DynamicIndex.

A record is the plain-dict durable form of one committed segment
(``Segment.to_record()``: ints, bytes, str and lists, vByte gap-coded
postings).  Both packages write and read the same form, so an index built
elsewhere serves here from the same committed state, at the same
addresses.
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.featurizer import Featurizer
from repro_torch.core.index import DynamicIndex, Segment
from repro_torch.core.tokenizer import Tokenizer


def index_from_records(records: Iterable[dict],
                       tokenizer: Optional[Tokenizer] = None,
                       featurizer: Optional[Featurizer] = None
                       ) -> DynamicIndex:
    """A new in-memory index holding the committed segments ``records``
    (``"ready"`` records, any order), as if each had been committed in
    seqnum order: new transactions get later seqnums and addresses."""
    segments = sorted((Segment.from_record(r) for r in records),
                      key=lambda s: s.seqnum)
    seqs = [s.seqnum for s in segments]
    if len(set(seqs)) != len(seqs):
        raise ValueError("two records share a seqnum")
    index = DynamicIndex(tokenizer, featurizer)
    for seg in segments:
        index._log.append(seg.to_record(), sync=False)
        index._log.append({"t": "commit", "seq": seg.seqnum}, sync=False)
    index._segments = tuple(segments)
    index._version = 1
    if segments:
        index._next_seq = segments[-1].seqnum + 1
        index._next_addr = max(s.base + s.length for s in segments)
    return index
