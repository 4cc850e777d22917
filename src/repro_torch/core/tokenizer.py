"""Tokenizers facilitate content addressability (paper Fig. 3).

A tokenizer's only role in a Warren is to split appended strings into the
tokens that occupy consecutive addresses.  Ranking-specific tokenization
(stemming, WordPiece, ...) is expressed through *features*, not here.

Operations: ``tokenize`` (tokens + character offsets), ``split`` (tokens
only), ``skip`` (count tokens without materializing them).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

from .featurizer import STRUCT_TOKENS


@dataclass(frozen=True)
class Token:
    text: str
    offset: int  # character offset into the appended string
    length: int  # character length


class Tokenizer:
    def tokenize(self, text: str) -> List[Token]:
        raise NotImplementedError

    def split(self, text: str) -> List[str]:
        return [t.text for t in self.tokenize(text)]

    def skip(self, text: str) -> int:
        return len(self.tokenize(text))


_ASCII_RE = re.compile(r"<[^>]*>|[A-Za-z0-9]+")


class AsciiTokenizer(Tokenizer):
    """Alphanumeric words; HTML-style tags kept whole (older TREC content)."""

    def tokenize(self, text: str) -> List[Token]:
        return [
            Token(m.group(0).lower(), m.start(), m.end() - m.start())
            for m in _ASCII_RE.finditer(text)
        ]


# Word characters: unicode letters/digits/underscore, plus each structural
# noncharacter is its own single token, plus "." for decimals inside numbers.
_UTF8_RE = re.compile(
    r"[" + "".join(STRUCT_TOKENS) + r"]|\w+(?:\.\w+)*",
    re.UNICODE,
)


class Utf8Tokenizer(Tokenizer):
    """Generic unicode word tokenizer; structural noncharacters are single
    tokens so JSON structure survives round-trips through the address space."""

    def tokenize(self, text: str) -> List[Token]:
        return [
            Token(m.group(0) if m.group(0) in STRUCT_TOKENS else m.group(0).lower(),
                  m.start(), m.end() - m.start())
            for m in _UTF8_RE.finditer(text)
        ]
