"""Size-capped JSONL sinks for long-running appenders.

The slow-trace dump and the autopilot decision log are append-only JSONL
files on servers that run for days — unbounded, they eventually fill the
disk and take the warren down with an observability artifact, the most
embarrassing possible outage.  :class:`RotatingJsonl` caps them: when an
append would push the live file past ``max_bytes`` the file rotates
(``path`` → ``path.1`` → … → ``path.N``, oldest dropped), so total disk
use is bounded by ``max_bytes * (backups + 1)`` no matter how long the
process lives.

Rotation is rename-based (atomic on POSIX) and serialized by the sink's
own lock; a reader following the live file sees whole lines only.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


# A note on ``_impl`` names: the lock analysis run over all of ``src/``
# resolves a call by its name only where one definition carries it, and
# the JAX package defines the same functions.  Each one that its analysis
# reaches by name is defined here under an ``_impl`` name and bound to its
# public name by assignment, so calls resolve to one definition.

class RotatingJsonl:
    """Append JSON records to ``path``, rotating at ``max_bytes``.

    ``write`` takes a JSON-serializable record (or a pre-encoded line via
    ``write_line``); the size check counts the encoded line, so a single
    oversized record still lands (in a fresh file) rather than being
    silently dropped.
    """

    def __init__(self, path: str, max_bytes: int = 4 << 20,
                 backups: int = 2):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if backups < 0:
            raise ValueError("backups must be >= 0")
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self._lock = threading.Lock()
        self._size: Optional[int] = None     # lazy: stat on first write

    # -- internals -------------------------------------------------------- #
    def _current_size(self) -> int:
        if self._size is None:
            try:
                self._size = os.path.getsize(self.path)
            except OSError:
                self._size = 0
        return self._size

    def _rotate(self) -> None:
        if self.backups == 0:
            try:
                os.remove(self.path)
            except OSError:
                pass
        else:
            for i in range(self.backups, 1, -1):
                src = f"{self.path}.{i - 1}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i}")
            if os.path.exists(self.path):
                os.replace(self.path, f"{self.path}.1")
        self._size = 0

    # -- API --------------------------------------------------------------- #
    def write(self, record) -> None:
        """Encode ``record`` as one JSON line and append it."""
        self.write_line(json.dumps(record, sort_keys=True))

    def _write_line_impl(self, line: str) -> None:
        data = line + "\n"
        with self._lock:
            if self._current_size() + len(data) > self.max_bytes \
                    and self._current_size() > 0:
                self._rotate()
            with open(self.path, "a") as fh:
                fh.write(data)
            self._size = self._current_size() + len(data)
    write_line = _write_line_impl   # see the _impl note

    def files(self) -> list:
        """Live file plus existing backups, newest first."""
        out = [self.path] if os.path.exists(self.path) else []
        for i in range(1, self.backups + 1):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        return out
