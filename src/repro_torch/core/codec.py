"""Compression codec for durable storage (log frames, static content).

The core index has zero hard native deps: zstandard is used when present,
otherwise the stdlib zlib.  Every compressed blob is self-describing — its
first byte names the codec — so a log written with zstd reads back fine in a
zlib-only environment *if* zstandard is importable there, and vice versa
always (zlib is stdlib).  Frame format stays `<u32 len><blob>`; only the
blob header gained the codec byte.
"""

from __future__ import annotations

import threading
import zlib

try:
    import zstandard as _zstd
except ImportError:          # pure-stdlib fallback
    _zstd = None

ZSTD = 1
ZLIB = 2

# zstandard's (de)compressor objects must not be used by two threads at
# once (they release the GIL and share one native context), so each thread
# keeps its own.
_local = threading.local()


def _contexts():
    if not hasattr(_local, "cctx"):
        _local.cctx = _zstd.ZstdCompressor(level=3)
        _local.dctx = _zstd.ZstdDecompressor()
    return _local.cctx, _local.dctx


def have_zstd() -> bool:
    return _zstd is not None


def compress(data: bytes, level: int = 3) -> bytes:
    """Compress with the best available codec; blob[0] is the codec id."""
    if _zstd is not None:
        cctx = (_contexts()[0] if level == 3
                else _zstd.ZstdCompressor(level=level))
        return bytes([ZSTD]) + cctx.compress(data)
    return bytes([ZLIB]) + zlib.compress(data, min(level + 3, 9))


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"   # raw zstd frame (pre-codec-byte files)


def decompress(blob: bytes) -> bytes:
    codec = blob[0]
    if blob[:4] == _ZSTD_MAGIC:      # legacy blob with no codec byte
        codec = ZSTD
        blob = b"\x00" + blob        # fall through with payload at blob[1:]
    if codec == ZSTD:
        if _zstd is None:
            raise RuntimeError(
                "blob was written with zstandard, which is not installed")
        return _contexts()[1].decompress(blob[1:])
    if codec == ZLIB:
        return zlib.decompress(blob[1:])
    raise ValueError(f"unknown codec byte {codec}")
