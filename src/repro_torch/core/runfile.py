"""Block-oriented immutable run file (static layout v2).

One file (``run.aix2``) per run directory::

    [block 0][block 1]...[block N-1][footer][trailer]

Each block is exactly ``block_size`` bytes: an 8-byte header (crc32 of the
used payload bytes + used length) followed by payload, zero-padded.  All
blocks carry ``block_size - 8`` payload bytes except possibly the last, so
a logical *payload-stream* offset maps to its block by integer division —
no per-block index needed.  Extents (a feature's posting blob, one content
record's compressed payload) are ``(offset, nbytes)`` pairs into the
payload stream and may span blocks.

The footer is a MessagePack document (``core/packing.py``) recording the
extent index — per-feature posting extents, per-record content extents with their address bounds, and
the run meta (erased intervals, seq/addr bounds).  The trailer is a
fixed-size struct at EOF: footer offset/length, footer crc32, magic.

Readers ``mmap`` the file, parse only footer + trailer eagerly, and fetch
blocks lazily through a pluggable block cache — the larger-than-memory
serving path.  Every block is crc-checked on (cache-miss) load; any
truncation, bit flip, bad magic, or impossible extent raises the typed
:class:`RunCorruption`, never a garbage decode.

Crash safety: the writer fsyncs the finished file and announces
``run.blocks_written`` / ``run.synced`` fault points
(:mod:`repro_torch.core.faults`); publication is the caller's atomic directory
rename.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from . import packing
from .faults import fault_point

MAGIC = b"AIX2"
FORMAT_VERSION = 2
RUN_FILE = "run.aix2"
DEFAULT_BLOCK_SIZE = 4096

_TRAILER = struct.Struct("<QQI4s")      # footer_off, footer_len, crc, magic
_BLOCK_HEADER = struct.Struct("<II")    # crc32(payload[:used]), used


class RunCorruption(RuntimeError):
    """A v2 run file failed a structural or crc check (truncation, bit
    flip, bad magic, extent out of bounds).  Reads never return garbage:
    every decode path raises this instead."""


class _NoCache:
    """Pass-through block 'cache' for standalone readers (plain
    :class:`~repro_torch.core.static.StaticIndex` outside a tiered store): every
    access loads from the mmap — the OS page cache is the only caching."""

    def get_or_load(self, key, loader, admit: bool = True) -> bytes:
        return loader()

    def pin(self, key) -> None:
        pass

    def unpin(self, key) -> None:
        pass


NO_CACHE = _NoCache()


# --------------------------------------------------------------------- #
class BlockRunWriter:
    """Streams payload extents into fixed-size crc'd blocks.

    ``append`` returns the extent of the bytes just written; ``finish``
    flushes the final partial block, writes footer + trailer, and fsyncs.
    Nothing is visible to readers until the caller publishes the directory
    (atomic rename) — a torn file is unreachable by construction.
    """

    def __init__(self, path: str, block_size: int = DEFAULT_BLOCK_SIZE):
        if block_size <= _BLOCK_HEADER.size:
            raise ValueError(f"block_size {block_size} too small")
        self.path = path
        self.block_size = block_size
        self.payload_cap = block_size - _BLOCK_HEADER.size
        self._fh = open(path, "wb")
        self._buf = bytearray()          # current (unflushed) block payload
        self._pos = 0                    # payload-stream length so far
        self._n_blocks = 0
        self._finished = False

    @property
    def tell(self) -> int:
        """Current payload-stream position (the next extent's offset)."""
        return self._pos

    def append(self, data: bytes) -> Tuple[int, int]:
        """Write one extent; returns ``(offset, nbytes)``."""
        off = self._pos
        view = memoryview(data)
        while len(view):
            room = self.payload_cap - len(self._buf)
            take = min(room, len(view))
            self._buf += view[:take]
            view = view[take:]
            if len(self._buf) == self.payload_cap:
                self._flush_block()
        self._pos = off + len(data)
        return off, len(data)

    def _flush_block(self) -> None:
        payload = bytes(self._buf)
        header = _BLOCK_HEADER.pack(zlib.crc32(payload), len(payload))
        block = header + payload
        if len(block) < self.block_size:
            block += b"\x00" * (self.block_size - len(block))
        self._fh.write(block)
        self._buf.clear()
        self._n_blocks += 1

    def finish(self, features: Dict[int, Tuple[int, int, int]],
               records: List[Tuple[int, int, int, int]],
               meta: dict) -> None:
        """Flush the tail block, then footer + trailer, then fsync."""
        if self._finished:
            raise RuntimeError("writer already finished")
        if self._buf:
            self._flush_block()
        fault_point("run.blocks_written")
        footer = packing.packb({
            "version": FORMAT_VERSION,
            "block_size": self.block_size,
            "n_blocks": self._n_blocks,
            "payload_len": self._pos,
            "features": {int(k): list(v) for k, v in features.items()},
            "records": [list(r) for r in records],
            "meta": meta,
        })
        footer_off = self._n_blocks * self.block_size
        self._fh.write(footer)
        self._fh.write(_TRAILER.pack(footer_off, len(footer),
                                     zlib.crc32(footer), MAGIC))
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._finished = True
        fault_point("run.synced")

    def abort(self) -> None:
        if not self._finished:
            self._fh.close()
            try:
                os.unlink(self.path)
            except OSError:
                pass


# --------------------------------------------------------------------- #
class BlockRunReader:
    """mmap-backed lazy reader over a v2 run file.

    Footer and trailer are parsed (and crc-checked) eagerly — they are
    small.  Block payloads are fetched on demand through the block cache;
    a cache miss loads the block from the mapping and verifies its crc, so
    a flipped bit anywhere in the block region surfaces as
    :class:`RunCorruption` on first touch, never as a garbage decode.
    Cache keys include the file's identity (device, inode) and footer crc,
    so two readers of the same file share cached blocks while a recycled
    inode cannot alias a stale entry.
    """

    def __init__(self, path: str, cache=None):
        self.path = path
        self._cache = cache if cache is not None else NO_CACHE
        self._fh = open(path, "rb")
        try:
            st = os.fstat(self._fh.fileno())
            if st.st_size < _TRAILER.size:
                raise RunCorruption(f"{path}: truncated (no trailer)")
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            size = st.st_size
            (footer_off, footer_len, footer_crc,
             magic) = _TRAILER.unpack(self._mm[size - _TRAILER.size:size])
            if magic != MAGIC:
                raise RunCorruption(f"{path}: bad magic {magic!r}")
            if footer_off + footer_len > size - _TRAILER.size:
                raise RunCorruption(f"{path}: footer extent out of bounds")
            footer_bytes = self._mm[footer_off:footer_off + footer_len]
            if zlib.crc32(footer_bytes) != footer_crc:
                raise RunCorruption(f"{path}: footer crc mismatch")
            try:
                footer = packing.unpackb(footer_bytes)
            except Exception as e:
                raise RunCorruption(f"{path}: footer undecodable: {e}") from e
            if footer.get("version") != FORMAT_VERSION:
                raise RunCorruption(
                    f"{path}: unsupported layout version "
                    f"{footer.get('version')!r}")
            self.block_size = int(footer["block_size"])
            self.payload_cap = self.block_size - _BLOCK_HEADER.size
            self.n_blocks = int(footer["n_blocks"])
            self.payload_len = int(footer["payload_len"])
            if self.n_blocks * self.block_size != footer_off:
                raise RunCorruption(
                    f"{path}: block region/footer offset mismatch")
            if not (self.payload_cap * (self.n_blocks - 1)
                    < self.payload_len <= self.payload_cap * self.n_blocks
                    or (self.payload_len == 0 and self.n_blocks == 0)):
                raise RunCorruption(f"{path}: payload length inconsistent")
            self.features: Dict[int, Tuple[int, int, int]] = {
                int(k): tuple(v) for k, v in footer["features"].items()}
            self.records: List[Tuple[int, int, int, int]] = [
                tuple(r) for r in footer["records"]]
            self.meta: dict = footer["meta"]
            self._key_base = (st.st_dev, st.st_ino, footer_crc)
            self._lock = threading.Lock()
        except Exception:
            self._fh.close()
            raise

    # -- block access --------------------------------------------------- #
    def _block_key(self, i: int):
        return (*self._key_base, i)

    def _load_block(self, i: int) -> bytes:
        lo = i * self.block_size
        raw = self._mm[lo:lo + self.block_size]
        if len(raw) < _BLOCK_HEADER.size:
            raise RunCorruption(f"{self.path}: block {i} truncated")
        crc, used = _BLOCK_HEADER.unpack(raw[:_BLOCK_HEADER.size])
        if used > self.payload_cap or _BLOCK_HEADER.size + used > len(raw):
            raise RunCorruption(
                f"{self.path}: block {i} used-length {used} impossible")
        payload = raw[_BLOCK_HEADER.size:_BLOCK_HEADER.size + used]
        if zlib.crc32(payload) != crc:
            raise RunCorruption(f"{self.path}: block {i} crc mismatch")
        return payload

    def read(self, offset: int, nbytes: int) -> bytes:
        """Assemble one payload-stream extent from its blocks (cached).

        Blocks are pinned in the cache for the duration of the assembly so
        a concurrent eviction sweep cannot drop a block another reader is
        mid-way through re-fetching (the cache-invariant tests exercise
        exactly this)."""
        if nbytes == 0:
            return b""
        if offset < 0 or nbytes < 0 or offset + nbytes > self.payload_len:
            raise RunCorruption(
                f"{self.path}: extent ({offset}, {nbytes}) beyond payload "
                f"length {self.payload_len}")
        cap = self.payload_cap
        first, last = offset // cap, (offset + nbytes - 1) // cap
        if last >= self.n_blocks:
            raise RunCorruption(
                f"{self.path}: extent ({offset}, {nbytes}) names block "
                f"{last} of {self.n_blocks}")
        parts = []
        cache = self._cache
        pinned = []
        try:
            for i in range(first, last + 1):
                key = self._block_key(i)
                payload = cache.get_or_load(key, lambda i=i:
                                            self._load_block(i))
                cache.pin(key)
                pinned.append(key)
                lo = max(0, offset - i * cap)
                hi = min(len(payload), offset + nbytes - i * cap)
                if hi > len(payload):
                    raise RunCorruption(
                        f"{self.path}: block {i} shorter than extent")
                parts.append(payload[lo:hi])
        finally:
            for key in pinned:
                cache.unpin(key)
        out = parts[0] if len(parts) == 1 else b"".join(parts)
        if len(out) != nbytes:
            raise RunCorruption(
                f"{self.path}: extent ({offset}, {nbytes}) assembled "
                f"{len(out)} bytes")
        return out

    def stream(self, offset: int, nbytes: int,
               admit: bool = False) -> Iterator[bytes]:
        """Yield an extent block-by-block WITHOUT admitting to the cache by
        default — the compaction/slice streaming path, so bulk scans never
        thrash resident reader blocks."""
        if nbytes == 0:
            return
        cap = self.payload_cap
        first, last = offset // cap, (offset + nbytes - 1) // cap
        for i in range(first, last + 1):
            payload = self._cache.get_or_load(
                self._block_key(i), lambda i=i: self._load_block(i),
                admit=admit)
            lo = max(0, offset - i * cap)
            hi = min(len(payload), offset + nbytes - i * cap)
            yield payload[lo:hi]

    def file_size(self) -> int:
        return os.fstat(self._fh.fileno()).st_size

    def close(self) -> None:
        try:
            self._mm.close()
        except Exception:
            pass
        try:
            self._fh.close()
        except Exception:
            pass


def is_v2_dir(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, RUN_FILE))
