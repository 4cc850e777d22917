"""Durable transaction log for the dynamic index (paper §5).

Append-only file of compressed MessagePack frames (``core/packing.py``;
zstd when available, zlib otherwise — see core/codec.py; the codec byte
lives in the blob header):

  {"t": "ready",  "seq": n, "base": p, "length": L, ...payload}
  {"t": "commit", "seq": n}
  {"t": "abort",  "seq": n}

``ready`` records are written (and fsynced) during the first phase of the
two-phase commit; the transaction is durable once its ``commit`` frame is on
disk.  Recovery replays the log: ready-without-commit ⇒ aborted, its address
interval becomes a gap.  ``compact`` rewrites the log as a single merged
snapshot frame plus the tail of still-live transactions.

With ``path=None`` the log is in memory and keeps the record dicts
themselves (records are never mutated after they are appended), so the
in-memory form needs neither packing nor a codec.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Any, Dict, Iterator, List, Optional

from . import codec, packing

_MAGIC = b"ANOTLOG1"


def _pack(record: Dict[str, Any]) -> bytes:
    payload = codec.compress(packing.packb(record))
    return struct.pack("<I", len(payload)) + payload


class TransactionLog:
    def __init__(self, path: Optional[str]):
        """path=None gives an in-memory (non-durable) log, useful for tests."""
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self._mem: List[Dict[str, Any]] = []
        if path is not None:
            exists = os.path.exists(path)
            self._fh = open(path, "ab")
            if not exists or os.path.getsize(path) == 0:
                self._fh.write(_MAGIC)
                self._fh.flush()
                os.fsync(self._fh.fileno())

    # ------------------------------------------------------------------ #
    def _write_frame(self, record: Dict[str, Any], sync: bool = True) -> None:
        if self.path is None:
            with self._lock:
                self._mem.append(record)
            return
        frame = _pack(record)
        with self._lock:
            self._fh.write(frame)
            self._fh.flush()
            if sync:
                os.fsync(self._fh.fileno())

    def append(self, record: Dict[str, Any], sync: bool = True) -> None:
        self._write_frame(record, sync=sync)

    def replay(self) -> Iterator[Dict[str, Any]]:
        if self.path is None:
            with self._lock:
                records = list(self._mem)
            yield from records
            return
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        with open(self.path, "rb") as fh:
            magic = fh.read(len(_MAGIC))
            if magic != _MAGIC:
                return
            while True:
                hdr = fh.read(4)
                if len(hdr) < 4:
                    return
                (n,) = struct.unpack("<I", hdr)
                payload = fh.read(n)
                if len(payload) < n:
                    return  # torn tail frame: treat as not written
                yield packing.unpackb(codec.decompress(payload))

    def compact(self, snapshot_records: List[Dict[str, Any]]) -> None:
        """Atomically replace the log with the given records."""
        if self.path is None:
            with self._lock:
                self._mem = list(snapshot_records)
            return
        tmp = self.path + ".compact"
        with open(tmp, "wb") as fh:
            fh.write(_MAGIC)
            for r in snapshot_records:
                fh.write(_pack(r))
            fh.flush()
            os.fsync(fh.fileno())
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
