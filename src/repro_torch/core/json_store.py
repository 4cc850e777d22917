"""A JSON store over the annotative index (paper Fig. 4-6).

JSON structure is kept *in the content* via Unicode noncharacter structural
tokens, and *in the features* via path annotations:

  ⟨:, (lo, hi)⟩                        object root (value 0)
  ⟨:name:, (p, q)⟩                     value interval of key "name"
  ⟨:batters:batter:, (p, q), len⟩      array extent, value = length
  ⟨:batters:batter:[1]:, (p, q)⟩       array element extent
  ⟨:ppu:, (p, q), 0.55⟩                numeric value as annotation value

Nothing is flattened: T(lo, hi) reproduces the full object.  A date
annotator shows post-hoc annotation (paper Examples 8/9): it unifies
heterogeneous date formats into year=/month=/day= features.

Kept identical to the reference package's store, so the same objects
yield the same addresses, features and values.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .featurizer import (STRUCT_COLON, STRUCT_COMMA, STRUCT_LBRACE,
                         STRUCT_LBRACKET, STRUCT_QUOTE, STRUCT_RBRACE,
                         STRUCT_RBRACKET)
from .gcl import GCLNode, Phrase, Term
from .tokenizer import Utf8Tokenizer

ROOT_FEATURE = ":"

_DISPLAY = {STRUCT_LBRACE: "{", STRUCT_RBRACE: "}", STRUCT_LBRACKET: "[",
            STRUCT_RBRACKET: "]", STRUCT_COLON: ":", STRUCT_COMMA: ",",
            STRUCT_QUOTE: '"'}


class _Emitter:
    def __init__(self, tokenizer: Utf8Tokenizer):
        self.tokenizer = tokenizer
        self.parts: List[str] = []
        self.pos = 0  # token count so far

    def emit(self, text: str) -> Tuple[int, int]:
        n = len(self.tokenizer.tokenize(text))
        lo = self.pos
        self.pos += n
        self.parts.append(text)
        return lo, self.pos - 1

    def text(self) -> str:
        return "".join(self.parts)


def _scalar_repr(v: Any) -> Tuple[str, Optional[float]]:
    if v is None:
        return "null", 0.0
    if isinstance(v, bool):
        return ("true", 1.0) if v else ("false", 0.0)
    if isinstance(v, (int, float)):
        return repr(v), float(v)
    return str(v), None


def add_json(w, obj: Any, collection: Optional[str] = None) -> Tuple[int, int]:
    """Append a JSON object inside an open transaction on warren ``w``.

    Returns the object's global or staging address extent.  ``collection``
    adds a collection-membership feature over the object (the paper's
    ``Files/books.json`` convention).
    """
    em = _Emitter(w.index.tokenizer)
    annotations: List[Tuple[str, int, int, float]] = []

    def _annotation_value(node: Any) -> float:
        """Path-annotation value: array length, numeric value, else 0."""
        if isinstance(node, list):
            return float(len(node))
        if isinstance(node, dict) or isinstance(node, str):
            return 0.0
        _, num = _scalar_repr(node)
        return num if num is not None else 0.0

    def walk(node: Any, path: str) -> Tuple[int, int]:
        if isinstance(node, dict):
            lo, _ = em.emit(STRUCT_LBRACE)
            for i, (key, val) in enumerate(node.items()):
                if i:
                    em.emit(STRUCT_COMMA)
                em.emit(f"{STRUCT_QUOTE}{key}{STRUCT_QUOTE}{STRUCT_COLON}")
                cpath = f"{path}{key}:"
                vlo, vhi = walk(val, cpath)
                annotations.append((cpath, vlo, vhi, _annotation_value(val)))
            _, hi = em.emit(STRUCT_RBRACE)
            return lo, hi
        if isinstance(node, list):
            lo, _ = em.emit(STRUCT_LBRACKET)
            for i, val in enumerate(node):
                if i:
                    em.emit(STRUCT_COMMA)
                epath = f"{path}[{i}]:"
                vlo, vhi = walk(val, epath)
                annotations.append((epath, vlo, vhi, _annotation_value(val)))
            _, hi = em.emit(STRUCT_RBRACKET)
            return lo, hi
        text, num = _scalar_repr(node)
        if num is None:  # string value: quoted
            lo, hi = em.emit(f"{STRUCT_QUOTE}{text}{STRUCT_QUOTE}")
        else:
            lo, hi = em.emit(text)
        return lo, hi

    rlo, rhi = walk(obj, ":")
    glo, ghi = w.append(em.text())
    assert ghi - glo == em.pos - 1, "token accounting mismatch"

    def g(a: int) -> int:
        return glo + a

    for path, lo, hi, v in annotations:
        w.annotate(path, g(lo), g(hi), v)
    w.annotate(ROOT_FEATURE, g(rlo), g(rhi))
    if collection:
        w.annotate(collection, g(rlo), g(rhi))
    return g(rlo), g(rhi)


def render_tokens(tokens: List[str]) -> str:
    """Human-readable rendering of content tokens (noncharacters mapped back)."""
    out: List[str] = []
    for t in tokens:
        if t in _DISPLAY:
            out.append(_DISPLAY[t])
        else:
            if out and out[-1] not in '{[:"' and not out[-1].endswith(('"', "{", "[", ":", ",")):
                out.append(" ")
            out.append(t)
    return "".join(out)


def value_of(warren, p: int, q: int) -> Optional[str]:
    """String value of a path annotation interval (quotes stripped)."""
    toks = warren.tokens(p, q)
    if toks is None:
        return None
    words = [t for t in toks if t not in _DISPLAY]
    return " ".join(words)


def raw_value_of(warren, p: int, q: int) -> Optional[str]:
    """Original text of a value interval (exact, via T(p,q))."""
    text = warren.translate(p, q)
    if text is None:
        return None
    for ch in _DISPLAY:
        text = text.replace(ch, "")
    return text.strip()


def string_match(warren, text: str) -> GCLNode:
    """GCL node matching a literal string value (phrase over word tokens)."""
    return warren.phrase(text)


# --------------------------------------------------------------------- #
# Post-hoc date annotation (paper Examples 8/9): heterogeneous date fields
# are unified by *annotating*, never rewriting, the stored objects.
# --------------------------------------------------------------------- #
_MONTHS = {m: i + 1 for i, m in enumerate(
    ["jan", "feb", "mar", "apr", "may", "jun",
     "jul", "aug", "sep", "oct", "nov", "dec"])}
_HUMAN_DATE = re.compile(r"^([a-z]{3})[a-z]*\s+(\d{1,2})\s+(\d{4})$")
_ISO_DATE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})")


def parse_date(value: str) -> Optional[Tuple[int, int, int]]:
    v = value.strip().lower()
    m = _HUMAN_DATE.match(v)
    if m and m.group(1) in _MONTHS:
        return int(m.group(3)), _MONTHS[m.group(1)], int(m.group(2))
    m = _ISO_DATE.match(v)
    if m:
        return int(m.group(1)), int(m.group(2)), int(m.group(3))
    if v.isdigit() and len(v) >= 12:  # unix millis
        d = _dt.datetime.fromtimestamp(int(v) / 1000.0, _dt.timezone.utc)
        return d.year, d.month, d.day
    return None


def annotate_dates(w, date_paths: Iterable[str]) -> int:
    """Read date-bearing fields via the index, write year=/month=/day=
    annotations in the same transaction.  Returns #annotated fields."""
    count = 0
    for path in date_paths:
        lst = w.annotations(path)
        for p, q, v in lst:
            if v and v > 1e11:  # numeric unix millis stored as value
                d = _dt.datetime.fromtimestamp(v / 1000.0, _dt.timezone.utc)
                ymd = (d.year, d.month, d.day)
            else:
                raw = raw_value_of(w, int(p), int(q))
                ymd = parse_date(raw) if raw else None
            if ymd is None:
                continue
            y, mo, dy = ymd
            w.annotate(f"year={y}", int(p), int(q))
            w.annotate(f"month={mo:02d}", int(p), int(q))
            w.annotate(f"day={dy:02d}", int(p), int(q))
            count += 1
    return count
