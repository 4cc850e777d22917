"""vByte (variable-byte) compression for gap-encoded posting lists.

Williams & Zobel (1999): each integer is emitted as 7-bit groups, low to
high, continuation bit set on all but the final byte.  Annotation lists
strictly increase in both start and end address (minimal-interval
semantics), so starts and ends are delta-encoded before compression; values
are zig-zag encoded (they are arbitrary 64-bit payloads).

Everything is vectorized with numpy; these codecs sit on the durable/on-disk
path (dynamic-index log records and static-index segments).
"""

from __future__ import annotations

import numpy as np


def encode(values: np.ndarray) -> bytes:
    """vByte-encode a 1-D array of non-negative int64 values."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size == 0:
        return b""
    if values.min() < 0:
        raise ValueError("vByte encodes non-negative integers; zig-zag first")
    # byte length per value: ceil(bitlen/7), min 1
    nbits = np.zeros(v.shape, dtype=np.int64)
    tmp = v.copy()
    while True:
        nz = tmp != 0
        if not nz.any():
            break
        nbits[nz] += 7
        tmp >>= np.uint64(7)
    nbytes = np.maximum(nbits // 7, 1)
    total = int(nbytes.sum())
    out = np.empty(total, dtype=np.uint8)
    # positions of each value's first byte
    starts = np.concatenate(([0], np.cumsum(nbytes)[:-1]))
    # emit up to 10 byte-planes
    remaining = v.copy()
    idx = starts.copy()
    alive = np.ones(v.shape, dtype=bool)
    for _ in range(10):
        if not alive.any():
            break
        byte = (remaining[alive] & np.uint64(0x7F)).astype(np.uint8)
        remaining[alive] >>= np.uint64(7)
        last = remaining[alive] == 0
        # continuation bit on all but the last byte of each value
        byte = byte | np.where(last, 0, 0x80).astype(np.uint8)
        out[idx[alive]] = byte
        idx[alive] += 1
        alive_idx = np.flatnonzero(alive)
        alive[alive_idx[last]] = False
    return out.tobytes()


def decode(data: bytes, count: int) -> np.ndarray:
    """Decode ``count`` vByte values from ``data`` (vectorized)."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    raw = np.frombuffer(data, dtype=np.uint8)
    is_last = (raw & 0x80) == 0
    ends = np.flatnonzero(is_last)[:count]
    starts = np.concatenate(([0], ends[:-1] + 1))
    out = np.zeros(count, dtype=np.uint64)
    maxlen = int((ends - starts).max()) + 1
    for plane in range(maxlen):
        pos = starts + plane
        valid = pos <= ends
        out[valid] |= (raw[pos[valid]].astype(np.uint64) & np.uint64(0x7F)) << np.uint64(7 * plane)
    return out.astype(np.int64)


def zigzag(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64).astype(np.int64)


def unzigzag(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.uint64)
    return ((v >> np.uint64(1)) ^ (np.uint64(0) - (v & np.uint64(1)))).astype(np.int64)


def encode_gaps(sorted_values: np.ndarray) -> bytes:
    """Gap-encode a strictly increasing array, then vByte."""
    v = np.asarray(sorted_values, dtype=np.int64)
    if v.size == 0:
        return b""
    gaps = np.concatenate(([v[0]], np.diff(v)))
    return encode(gaps)


def decode_gaps(data: bytes, count: int) -> np.ndarray:
    gaps = decode(data, count)
    return np.cumsum(gaps)
