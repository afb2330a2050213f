"""Minimal protobuf wire-format writer: the encoders sign bytes need.

A copy of the writer side of the JAX package's ``utils/proto.py``
(reference proto/tendermint/*, libs/protoio framing): standard proto
wire format, so canonical sign bytes are byte-identical in both
packages.
"""

from __future__ import annotations

import struct

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2

# one/two-byte fast paths: most varints are tags, lengths, small ints
_V1 = [bytes([i]) for i in range(128)]
_V2 = [bytes([(i & 0x7F) | 0x80, i >> 7]) for i in range(128, 1 << 14)]


def varint(v: int) -> bytes:
    """Unsigned varint (LEB128); negatives as 10-byte two's complement."""
    if 0 <= v < 128:
        return _V1[v]
    if 128 <= v < 1 << 14:
        return _V2[v - 128]
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def field_varint(field: int, v: int) -> bytes:
    if v == 0:
        return b""
    return tag(field, WIRE_VARINT) + varint(v)


def field_sfixed64(field: int, v: int) -> bytes:
    if v == 0:
        return b""
    return tag(field, WIRE_FIXED64) + struct.pack("<q", v)


def field_bytes(field: int, v: bytes) -> bytes:
    if not v:
        return b""
    return tag(field, WIRE_BYTES) + varint(len(v)) + v


def field_string(field: int, v: str) -> bytes:
    return field_bytes(field, v.encode())


def field_message(field: int, v: bytes) -> bytes:
    """Embedded message: emitted even when empty iff v is not None."""
    if v is None:
        return b""
    return tag(field, WIRE_BYTES) + varint(len(v)) + v


def delimited(payload: bytes) -> bytes:
    """Length-prefixed framing (libs/protoio MarshalDelimited)."""
    return varint(len(payload)) + payload


def timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp from integer unix nanoseconds."""
    secs, nanos = divmod(ns, 1_000_000_000)
    return field_varint(1, secs) + field_varint(2, nanos)
