"""Seeded synthetic corpus: Zipfian TREC-like documents.

The same seed yields the same documents as the reference package's
``doc_generator``, so both index the same text.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

_WORDS = """time year people way day man thing woman life child world school
state family student group country problem hand part place case week company
system program question work government number night point home water room
mother area money story fact month lot right study book eye job word business
issue side kind head house service friend father power hour game line end
member law car city community name president team minute idea body
information back parent face others level office door health person art war
history party result change morning reason research girl guy moment air
teacher force education vibration transmission conductor aeolian wind
frequency damping resonance amplitude""".split()


def doc_generator(seed: int, n_docs: int, mean_len: int = 80) -> Iterator[Tuple[str, str]]:
    """Yields (docid, text) with Zipfian vocabulary (TREC-like)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(_WORDS) + 1) ** 1.1
    probs /= probs.sum()
    for i in range(n_docs):
        n = max(8, int(rng.normal(mean_len, mean_len / 3)))
        words = rng.choice(_WORDS, size=n, p=probs)
        yield f"doc{seed}_{i}", " ".join(words)
