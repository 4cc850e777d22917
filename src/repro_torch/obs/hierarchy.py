"""The declared lock hierarchy, read from ``analysis/lock_hierarchy.toml``
for the runtime witness
(:meth:`repro_torch.obs.witness.LockWitness.from_hierarchy`).

Copies of the JAX package's ``LockLevel`` / ``Hierarchy`` and of its small
TOML-subset reader (``loads`` / ``load``), so the telemetry plane reads the
hierarchy with the standard library alone.  The reader takes ``[section]``,
``[a."quoted name"]`` and ``[[name]]`` tables and ``key = value`` lines with
string, int, float, bool and array-of-scalar values (arrays may span
lines); anything else raises :class:`TomlError`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

# --------------------------------------------------------------------- #
# lock hierarchy
# --------------------------------------------------------------------- #
@dataclass
class LockLevel:
    name: str
    rank: int
    hot: bool = False
    # "none"      — single instance, nested same-class acquire is a bug
    # "reentrant" — RLock semantics: same-instance re-acquire is legal
    # "ascending" — many instances, must be acquired in ascending
    #               order-key order (the group-write rule)
    multi: str = "none"


@dataclass
class Hierarchy:
    levels: Dict[str, LockLevel] = field(default_factory=dict)
    blocking_calls: List[str] = field(default_factory=list)

    def _rank_impl(self, name: str) -> Optional[int]:
        lvl = self.levels.get(name)
        return None if lvl is None else lvl.rank
    rank = _rank_impl   # see the _impl note

    def _is_hot_impl(self, name: str) -> bool:
        lvl = self.levels.get(name)
        return lvl is not None and lvl.hot
    is_hot = _is_hot_impl   # see the _impl note

    def _multi_impl(self, name: str) -> str:
        lvl = self.levels.get(name)
        return "none" if lvl is None else lvl.multi
    multi = _multi_impl   # see the _impl note

    def ordered(self) -> List[LockLevel]:
        return sorted(self.levels.values(), key=lambda l: l.rank)

    @classmethod
    def load(cls, path: Optional[str]) -> "Hierarchy":
        if path is None:
            return cls()
        doc = load(path)     # the module's TOML reader below
        levels: Dict[str, LockLevel] = {}
        for name, spec in doc.get("locks", {}).items():
            if not isinstance(spec, dict) or "rank" not in spec:
                raise ValueError(f"lock level {name!r} needs a rank")
            multi = str(spec.get("multi", "none"))
            if multi not in ("none", "reentrant", "ascending"):
                raise ValueError(f"lock level {name!r}: bad multi={multi!r}")
            levels[name] = LockLevel(
                name=name, rank=int(spec["rank"]),
                hot=bool(spec.get("hot", False)), multi=multi)
        ranks: Dict[int, str] = {}
        for lvl in levels.values():
            if lvl.rank in ranks:
                raise ValueError(
                    f"lock levels {ranks[lvl.rank]!r} and {lvl.name!r} "
                    f"share rank {lvl.rank} — the hierarchy must be a "
                    "total order over declared locks")
            ranks[lvl.rank] = lvl.name
        blocking = [str(c) for c in
                    doc.get("blocking", {}).get("calls", [])]
        return cls(levels=levels, blocking_calls=blocking)


# --------------------------------------------------------------------- #
# TOML-subset reader
# --------------------------------------------------------------------- #
class TomlError(ValueError):
    pass


_KEY_RE = re.compile(r'^([A-Za-z0-9_\-]+|"[^"]*")\s*=\s*(.*)$')


def _parse_key(raw: str) -> str:
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    return raw


def _split_dotted(header: str) -> List[str]:
    """Split ``a.b."c.d"`` into ['a', 'b', 'c.d']."""
    parts, buf, i, n = [], "", 0, len(header)
    while i < n:
        c = header[i]
        if c == '"':
            j = header.index('"', i + 1)
            buf += header[i + 1:j]
            i = j + 1
        elif c == ".":
            parts.append(buf.strip())
            buf = ""
            i += 1
        else:
            buf += c
            i += 1
    parts.append(buf.strip())
    if any(not p for p in parts):
        raise TomlError(f"bad table header: {header!r}")
    return parts


def _strip_comment(line: str) -> str:
    out, in_str = [], False
    for c in line:
        if c == '"':
            in_str = not in_str
        if c == "#" and not in_str:
            break
        out.append(c)
    return "".join(out).rstrip()


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    raise TomlError(f"unsupported value: {tok!r}")


def _split_array_items(body: str) -> List[str]:
    items, buf, in_str = [], "", False
    for c in body:
        if c == '"':
            in_str = not in_str
            buf += c
        elif c == "," and not in_str:
            if buf.strip():
                items.append(buf.strip())
            buf = ""
        else:
            buf += c
    if buf.strip():
        items.append(buf.strip())
    return items


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise TomlError(f"unterminated array: {tok!r}")
        return [_parse_scalar(t) for t in _split_array_items(tok[1:-1])]
    return _parse_scalar(tok)


def loads(text: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    current = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise TomlError(f"bad array-of-tables header: {line!r}")
            path = _split_dotted(line[2:-2])
            node = root
            for p in path[:-1]:
                node = node.setdefault(p, {})
            arr = node.setdefault(path[-1], [])
            if not isinstance(arr, list):
                raise TomlError(f"{'.'.join(path)} is not an array of tables")
            current = {}
            arr.append(current)
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise TomlError(f"bad table header: {line!r}")
            path = _split_dotted(line[1:-1])
            node = root
            for p in path:
                nxt = node.setdefault(p, {})
                if not isinstance(nxt, dict):
                    raise TomlError(f"table {p!r} collides with a value")
                node = nxt
            current = node
            continue
        m = _KEY_RE.match(line)
        if m is None:
            raise TomlError(f"cannot parse line: {line!r}")
        key, val = _parse_key(m.group(1)), m.group(2).strip()
        # multi-line array: keep consuming until brackets balance
        while val.startswith("[") and not val.endswith("]"):
            if i >= len(lines):
                raise TomlError(f"unterminated array for key {key!r}")
            val += " " + _strip_comment(lines[i]).strip()
            i += 1
        current[key] = _parse_value(val)
    return root


def load(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        return loads(fh.read())
