"""Structural query language: text → GCL operator tree (paper Fig. 2).

The paper's Conclusion envisions LLMs emitting structural queries; this is
the textual syntax they would emit.  Grammar (precedence low → high):

  expr    := or
  or      := and ( "|" and )*                       A ▽ B   one of
  and     := seq ( "&" seq )*                       A △ B   both of
  seq     := cont ( "..." cont )*                   A ◇ B   followed by
  cont    := atom ( ("<<" | ">>" | "!<<" | "!>>") atom )*
             A << B  contained in      A >> B  containing
             !<<     not contained in  !>>     not containing
  atom    := "(" expr ")" | '"phrase words"' | "[feature]" | word

  word          a single term (tokenized, stemless content word)
  "…"           phrase (adjacent tokens)
  [feature]     a raw feature name, e.g. [:city:], [Files/zips.json],
                [year=2008]

Examples (paper Fig. 6):
  [:city:] >> "new york" << [Files/zips.json]
  [:] >> ([year=2008] & [month=12] & [day=01])
  [:title:] | [:authors:] << [Files/books.json]
"""

from __future__ import annotations

import re
from typing import List, Optional

from .annotation import AnnotationList
from .gcl import (BothOf, ContainedIn, Containing, FollowedBy, GCLNode,
                  NotContainedIn, NotContaining, OneOf, Phrase, Term)

_TOKEN_RE = re.compile(r"""
    (?P<phrase>"[^"]*")
  | (?P<feature>\[[^\]]+\])
  | (?P<op><<|>>|!<<|!>>|\||&|\.\.\.|\(|\))
  | (?P<word>[^\s()"\[\]|&<>!]+)
""", re.VERBOSE)


class QueryError(ValueError):
    pass


def _lex(text: str) -> List[tuple]:
    out = []
    pos = 0
    for m in _TOKEN_RE.finditer(text):
        if text[pos:m.start()].strip():
            raise QueryError(f"bad syntax near {text[pos:m.start()]!r}")
        pos = m.end()
        if m.lastgroup == "op":
            out.append(("op", m.group()))
        elif m.lastgroup == "phrase":
            out.append(("phrase", m.group()[1:-1]))
        elif m.lastgroup == "feature":
            out.append(("feature", m.group()[1:-1]))
        else:
            out.append(("word", m.group()))
    if text[pos:].strip():
        raise QueryError(f"bad syntax near {text[pos:]!r}")
    return out


class _Parser:
    def __init__(self, tokens: List[tuple], warren):
        self.toks = tokens
        self.i = 0
        self.w = warren

    def _peek(self) -> Optional[tuple]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _eat(self, kind=None, value=None):
        t = self._peek()
        if t is None or (kind and t[0] != kind) or (value and t[1] != value):
            raise QueryError(f"expected {value or kind}, got {t}")
        self.i += 1
        return t

    def parse(self) -> GCLNode:
        node = self.expr()
        if self._peek() is not None:
            raise QueryError(f"trailing input: {self._peek()}")
        return node

    def expr(self) -> GCLNode:
        node = self.and_()
        while self._peek() == ("op", "|"):
            self._eat()
            node = OneOf(node, self.and_())
        return node

    def and_(self) -> GCLNode:
        node = self.seq()
        while self._peek() == ("op", "&"):
            self._eat()
            node = BothOf(node, self.seq())
        return node

    def seq(self) -> GCLNode:
        node = self.cont()
        while self._peek() == ("op", "..."):
            self._eat()
            node = FollowedBy(node, self.cont())
        return node

    def cont(self) -> GCLNode:
        node = self.atom()
        ops = {"<<": ContainedIn, ">>": Containing,
               "!<<": NotContainedIn, "!>>": NotContaining}
        while self._peek() is not None and self._peek()[0] == "op" \
                and self._peek()[1] in ops:
            op = self._eat()[1]
            node = ops[op](node, self.atom())
        return node

    def atom(self) -> GCLNode:
        t = self._peek()
        if t is None:
            raise QueryError("unexpected end of query")
        if t == ("op", "("):
            self._eat()
            node = self.expr()
            self._eat("op", ")")
            return node
        if t[0] == "phrase":
            self._eat()
            return self.w.phrase(t[1])
        if t[0] == "feature":
            self._eat()
            return self.w.hopper(t[1])
        if t[0] == "word":
            self._eat()
            return self.w.hopper(t[1].lower())
        raise QueryError(f"unexpected {t}")


def parse_query(text: str, warren) -> GCLNode:
    """Compile query text to a lazy GCL node over an open warren/reader."""
    return _Parser(_lex(text), warren).parse()


def solve(text: str, warren, limit: int = 1000):
    """Parse + enumerate solutions (paper's Solve loop)."""
    node = parse_query(text, warren)
    out = node.solutions()
    return out[:limit]
