"""The port's MessagePack codec against the ``msgpack`` package.

``repro_torch.core.packing`` writes the index's durable records (the
transaction log, run footers, content payloads) without ``msgpack``; its
bytes must be ``msgpack.packb(obj, use_bin_type=True)``'s and its decoding
``msgpack.unpackb(b, raw=False, strict_map_key=False)``'s, so each package
reads the other's files.
"""

import math
import struct

import pytest
from hypothesis import given, settings, strategies as st

msgpack = pytest.importorskip("msgpack")

from repro_torch.core import packing  # noqa: E402

SETTINGS = settings(database=None, derandomize=True, deadline=None,
                    max_examples=200)

SCALARS = (st.none() | st.booleans()
           | st.integers(-(1 << 63), (1 << 64) - 1)
           | st.floats(allow_nan=True, allow_infinity=True)
           | st.text(max_size=40) | st.binary(max_size=40))
VALUES = st.recursive(
    SCALARS,
    lambda inner: (st.lists(inner, max_size=6)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8)
                                     | st.integers(-300, 1 << 40),
                                     inner, max_size=6)),
    max_leaves=30)


def _same(a, b) -> bool:
    """Structural equality with NaN equal to NaN (bit patterns aside)."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


@SETTINGS
@given(VALUES)
def test_packb_is_msgpack_byte_for_byte(obj):
    assert packing.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@SETTINGS
@given(VALUES)
def test_unpackb_reads_msgpack_and_round_trips(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    got = packing.unpackb(raw)
    assert _same(got, msgpack.unpackb(raw, raw=False, strict_map_key=False))
    assert packing.packb(got) == raw


INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1,
             1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, -1, -32, -33,
             -128, -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1,
             -(1 << 63)]


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_encoding_edges(n):
    raw = msgpack.packb(n, use_bin_type=True)
    assert packing.packb(n) == raw
    assert packing.unpackb(raw) == n


@pytest.mark.parametrize("size", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_length_encoding_edges(size):
    """Every length family at its fix / 8 / 16 / 32-bit boundaries."""
    for obj in ("é" * (size // 2) + "a" * (size % 2), b"\x00" * size,
                list(range(size % 300)) * (size // max(size % 300, 1))
                if size else [],
                {i: None for i in range(size)}):
        raw = msgpack.packb(obj, use_bin_type=True)
        assert packing.packb(obj) == raw, (type(obj), size)
        assert _same(packing.unpackb(raw),
                     msgpack.unpackb(raw, raw=False, strict_map_key=False))


def test_special_values():
    for obj in (float("nan"), float("-inf"), -0.0, [], {}, "", b"",
                bytearray(b"ab"), memoryview(b"cd"), (1, (2, [3])),
                {b"k": 1, 2: "v", None: [], 1.5: True}):
        assert packing.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    nan = packing.unpackb(packing.packb(float("nan")))
    assert math.isnan(nan)
    neg0 = packing.unpackb(packing.packb(-0.0))
    assert struct.pack(">d", neg0) == struct.pack(">d", -0.0)


def test_float32_is_read():
    raw = msgpack.packb(1.5, use_single_float=True)
    assert raw[0] == 0xCA
    assert packing.unpackb(raw) == 1.5


def test_refusals():
    with pytest.raises(OverflowError):
        packing.packb(1 << 64)
    with pytest.raises(OverflowError):
        packing.packb(-(1 << 63) - 1)
    with pytest.raises(TypeError):
        packing.packb(object())
    with pytest.raises(TypeError):
        packing.packb({1, 2})
    with pytest.raises(packing.PackingError):
        packing.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(packing.PackingError):
        packing.unpackb(packing.packb([1, 2]) + b"\x00")
    with pytest.raises(packing.PackingError):
        packing.unpackb(packing.packb("abcdef")[:-1])


def test_segment_record_bytes_equal():
    """A real transaction-log record: the port's bytes are msgpack's and
    each side decodes the other's."""
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    w = Warren(DynamicIndex())
    ingest_documents(w, doc_generator(3, 40, mean_len=30), batch=40)
    rec = w.index._segments[-1].to_record()
    raw = msgpack.packb(rec, use_bin_type=True)
    assert packing.packb(rec) == raw
    assert packing.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                   strict_map_key=False)
