"""Minimal protobuf wire format: the writer and the reader.

A copy of the JAX package's ``utils/proto.py`` (reference
proto/tendermint/*, libs/protoio framing): standard proto wire format,
so canonical sign bytes, block encodings and store records are
byte-identical in both packages.
"""

from __future__ import annotations

import struct

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5

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


# --- reader side --------------------------------------------------------


def read_varint(buf: bytes, pos: int):
    """Returns (value, new_pos); the value fit to signed 64-bit."""
    shift = 0
    out = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")
    if out >= 1 << 63:
        out -= 1 << 64
    return out, pos


def parse(buf: bytes):
    """Parse a message into {field: [value, ...]} in wire order:
    varint and fixed fields as int, length-delimited ones as bytes."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        raise ValueError(f"expected message bytes, got {type(buf).__name__}")
    out = {}
    pos = 0
    while pos < len(buf):
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == WIRE_VARINT:
            v, pos = read_varint(buf, pos)
        elif wire == WIRE_FIXED64:
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64 field")
            (v,) = struct.unpack_from("<q", buf, pos)
            pos += 8
        elif wire == WIRE_BYTES:
            ln, pos = read_varint(buf, pos)
            v = bytes(buf[pos : pos + ln])
            if len(v) != ln:
                raise ValueError("truncated bytes field")
            pos += ln
        elif wire == WIRE_FIXED32:
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32 field")
            (v,) = struct.unpack_from("<i", buf, pos)
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def get1(msg, field, default=None):
    """First value of a field, typed by the default: a wire value of
    another type (varint where bytes are expected, or the reverse)
    raises ValueError."""
    vs = msg.get(field)
    if not vs:
        return default
    v = vs[0]
    if isinstance(default, (bytes, bytearray)):
        if not isinstance(v, (bytes, bytearray)):
            raise ValueError(f"field {field}: expected bytes, got {type(v).__name__}")
    elif isinstance(default, int):
        if not isinstance(v, int):
            raise ValueError(f"field {field}: expected varint, got {type(v).__name__}")
    return v


def parse_timestamp(b: bytes) -> int:
    if not b:
        return 0
    m = parse(b)
    return get1(m, 1, 0) * 1_000_000_000 + get1(m, 2, 0)
