"""Featurizers map feature strings to 64-bit values (paper Fig. 3).

By convention a feature mapped to 0 is not indexed.  ``HashingFeaturizer``
implements MurmurHash64A; wrappers record vocabulary or suppress structural
tokens (``JsonFeaturizer``).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

_MASK64 = (1 << 64) - 1


def murmur64a(data: bytes, seed: int = 0x8445D61A4E774912) -> int:
    """MurmurHash64A (Austin Appleby), pure-python, matches the reference C."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _MASK64)) & _MASK64
    n = len(data) // 8
    for i in range(n):
        k = int.from_bytes(data[i * 8:(i + 1) * 8], "little")
        k = (k * m) & _MASK64
        k ^= k >> r
        k = (k * m) & _MASK64
        h ^= k
        h = (h * m) & _MASK64
    tail = data[n * 8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK64
    h ^= h >> r
    h = (h * m) & _MASK64
    h ^= h >> r
    return h


class Featurizer:
    """Base featurizer interface: ``featurize(feature: str) -> int``."""

    def featurize(self, feature: str) -> int:
        raise NotImplementedError

    def translate(self, fval: int) -> Optional[str]:
        """Reverse lookup when the featurizer records vocabulary, else None."""
        return None


class HashingFeaturizer(Featurizer):
    def __init__(self, seed: int = 0x8445D61A4E774912):
        self.seed = seed

    def featurize(self, feature: str) -> int:
        h = murmur64a(feature.encode("utf-8"), self.seed)
        return h if h != 0 else 1  # 0 is reserved (= not indexed / erased)


class VocabFeaturizer(Featurizer):
    """Wraps another featurizer and records the vocabulary for reverse lookup."""

    def __init__(self, inner: Optional[Featurizer] = None):
        self.inner = inner or HashingFeaturizer()
        self._vocab: Dict[int, str] = {}
        self._lock = threading.Lock()

    def featurize(self, feature: str) -> int:
        fval = self.inner.featurize(feature)
        if fval != 0:
            with self._lock:
                self._vocab.setdefault(fval, feature)
        return fval

    def translate(self, fval: int) -> Optional[str]:
        return self._vocab.get(fval)

    def vocabulary(self) -> Iterable[str]:
        return list(self._vocab.values())


# Unicode noncharacters are permanently reserved for internal use; the paper
# uses them to encode JSON structural elements inside the content stream.
STRUCT_LBRACE = "﷐"
STRUCT_RBRACE = "﷑"
STRUCT_LBRACKET = "﷒"
STRUCT_RBRACKET = "﷓"
STRUCT_COLON = "﷔"
STRUCT_COMMA = "﷕"
STRUCT_QUOTE = "﷖"
STRUCT_TOKENS = frozenset(
    {
        STRUCT_LBRACE,
        STRUCT_RBRACE,
        STRUCT_LBRACKET,
        STRUCT_RBRACKET,
        STRUCT_COLON,
        STRUCT_COMMA,
        STRUCT_QUOTE,
    }
)


class JsonFeaturizer(Featurizer):
    """Maps JSON structural tokens to 0 (not indexed); delegates otherwise."""

    def __init__(self, inner: Optional[Featurizer] = None):
        self.inner = inner or VocabFeaturizer()

    def featurize(self, feature: str) -> int:
        if feature in STRUCT_TOKENS:
            return 0
        return self.inner.featurize(feature)

    def translate(self, fval: int) -> Optional[str]:
        return self.inner.translate(fval)
