"""Index-backed training data pipeline (the paper's RAG-ingestion scenario
as the LM input path; ``src/repro/data/pipeline.py``), over the port's
``Warren``.  The same documents give the same annotations and the same
batches, bit for bit, as the reference's.

Stage 1 (ingest):  append documents, annotate ':' extents.
Stage 2 (dedup):   content-hash duplicates marked with 'dup:' annotations —
                   written *after* ingestion, in separate transactions, which
                   is precisely what annotative indexing enables.
Stage 3 (segment): fixed-window/stride segmentation recorded as 'seg:'
                   annotations over the content (window/stride in tokens,
                   like the MS MARCO segmentation in the paper's intro).

The loader walks 'seg:' extents via τ, hydrates token spans with
Snapshot.tokens, hashes words to ids, and emits deterministic, resumable
batches (iterator state = (segment cursor, epoch) — checkpointable).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import Warren, index_document
from repro_torch.core.featurizer import murmur64a

SEG_FEATURE = "seg:"
DUP_FEATURE = "dup:"


def ingest(warren: Warren, docs, batch_docs: int = 64) -> int:
    """Stage 1: one transaction per batch of documents."""
    n = 0
    it = iter(docs)
    done = False
    while not done:
        with warren:
            warren.transaction()
            wrote = 0
            for _ in range(batch_docs):
                try:
                    docid, text = next(it)
                except StopIteration:
                    done = True
                    break
                index_document(warren, text, docid=docid)
                wrote += 1
                n += 1
            if wrote:
                warren.commit()
            else:
                warren.abort()
    return n


def mark_duplicates(warren: Warren) -> int:
    """Stage 2: annotate exact-duplicate documents (keep first)."""
    seen: Dict[str, int] = {}
    dups: List[Tuple[int, int]] = []
    with warren:
        docs = warren.annotations(":")
        for p, q, _ in docs:
            text = warren.translate(int(p), int(q))
            h = hashlib.sha1(text.encode()).hexdigest()
            if h in seen:
                dups.append((int(p), int(q)))
            else:
                seen[h] = int(p)
    if dups:
        with warren:
            warren.transaction()
            for p, q in dups:
                warren.annotate(DUP_FEATURE, p, q)
            warren.commit()
    return len(dups)


def segment(warren: Warren, window: int = 128, stride: int = 64) -> int:
    """Stage 3: sliding-window segmentation as annotations (value=index)."""
    n = 0
    with warren:
        docs = warren.annotations(":")
        dups = warren.annotations(DUP_FEATURE)
        dup_starts = set(int(s) for s in dups.starts)
        warren.transaction()
        for p, q, _ in docs:
            p, q = int(p), int(q)
            if p in dup_starts:
                continue
            i = 0
            while True:
                lo = p + i * stride
                hi = min(lo + window - 1, q)
                if lo > q:
                    break
                warren.annotate(SEG_FEATURE, lo, hi, float(i))
                n += 1
                if hi == q:
                    break
                i += 1
        warren.commit()
    return n


def token_id(word: str, vocab: int) -> int:
    return int(murmur64a(word.encode()) % (vocab - 2)) + 2  # 0=pad, 1=bos


class IndexedCorpusLoader:
    """Deterministic, resumable batches from 'seg:' extents."""

    def __init__(self, warren: Warren, vocab: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.warren = warren
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        with warren:
            segs = warren.annotations(SEG_FEATURE)
            self.extents = [(int(p), int(q)) for p, q, _ in segs]
        if not self.extents:
            raise ValueError("no segments; run pipeline stages first")
        self.order = np.random.default_rng(seed).permutation(len(self.extents))
        self.cursor = 0
        self.epoch = 0

    def state(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "epoch": self.epoch}

    def restore(self, state: Dict[str, int]) -> None:
        self.cursor = int(state["cursor"])
        self.epoch = int(state["epoch"])
        self.order = np.random.default_rng(self.seed + self.epoch
                                           ).permutation(len(self.extents))

    def _segment_tokens(self, p: int, q: int) -> List[int]:
        with self.warren:
            toks = self.warren.tokens(p, q)
        toks = toks or []
        return [token_id(t, self.vocab) for t in toks]

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = np.zeros((self.batch, self.seq_len + 1), np.int32)
        for b in range(self.batch):
            if self.cursor >= len(self.order):
                self.epoch += 1
                self.cursor = 0
                self.order = np.random.default_rng(self.seed + self.epoch
                                                   ).permutation(len(self.extents))
            p, q = self.extents[self.order[self.cursor]]
            self.cursor += 1
            ids = [1] + self._segment_tokens(p, q)[: self.seq_len]
            out[b, :len(ids)] = ids
        return {"tokens": out[:, :-1], "labels": out[:, 1:].astype(np.int32),
                "_state": self.state()}
