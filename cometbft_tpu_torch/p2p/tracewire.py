"""The trace-context stamp's wire framing, receive side only.

The JAX package's ``p2p/tracewire.py`` lets consensus, mempool and
blocksync messages ride the wire with an optional causal-trace stamp:

    MAGIC(2) | uvarint(hdr_len >= 1) | hdr | payload      stamped
    MAGIC(2) | 0x00                  | payload            escape
    payload                                               unstamped

The port does not stamp (the cross-node tracing plane is not ported),
but it keeps the two halves of the framing that interoperation needs:
``unstamp`` peels a stamp or an escape from every received message, so
a stamping JAX peer's messages reach the reactors unchanged, and
``encode_plain`` escapes an outbound payload that happens to begin
with MAGIC, so a JAX receiver's always-on peel cannot mutate it. Both
are copies of the JAX functions; ``unstamp`` returns the decoded
context, which the port's switch drops.
"""

from __future__ import annotations

from typing import Optional, Tuple

# 0xB7 echoes the mempool codec's non-ASCII lead byte; 0x54 = "T"
MAGIC = b"\xb7\x54"

# message kinds a stamp may carry (wire ids are positional)
KINDS = (
    "proposal",
    "block_part",
    "vote",
    "commit_block",
    "txs",
    "bs.status",
    "bs.request",
    "bs.block",
)

_MAX_ORIGIN_LEN = 32


class TraceCtx:
    """Decoded stamp: who sent this message, about what, and when
    (origin monotonic ns)."""

    __slots__ = ("kind", "seq", "send_ns", "clock", "height", "round", "origin")

    def __init__(self, kind, seq, send_ns, clock, height, round_, origin):
        self.kind = kind
        self.seq = seq
        self.send_ns = send_ns
        self.clock = clock
        self.height = height
        self.round = round_
        self.origin = origin


def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated/overlong varint")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def escape(payload: bytes) -> bytes:
    """Zero-header frame: a payload that happens to begin with MAGIC,
    wrapped so the receiver cannot misparse it as a stamp."""
    return MAGIC + b"\x00" + payload


def encode_plain(payload: bytes, cap: int = 0) -> bytes:
    """Wire form for an unstamped send: raw bytes, escaping only the
    (vanishingly rare) MAGIC-prefixed payload so the receiver's
    always-on peel cannot mutate it. ``cap`` is the channel's max
    message size: a magic-prefixed payload within 3 bytes of the cap
    goes out raw rather than oversized."""
    if payload.startswith(MAGIC) and (not cap or len(payload) + len(MAGIC) + 1 <= cap):
        return escape(payload)
    return payload


def unstamp(msg: bytes) -> Tuple[Optional[TraceCtx], bytes]:
    """(ctx-or-None, payload). Anything unparseable — including a
    peer's raw message that happens to begin with MAGIC — comes back
    as (None, msg) unchanged."""
    if not msg.startswith(MAGIC):
        return None, msg
    try:
        hdr_len, pos = _read_uvarint(msg, len(MAGIC))
        if hdr_len == 0:
            return None, msg[pos:]  # escape frame
        end = pos + hdr_len
        if end > len(msg):
            raise ValueError("truncated header")
        kind_id, pos = _read_uvarint(msg, pos)
        if kind_id >= len(KINDS):
            raise ValueError("unknown kind id")
        seq, pos = _read_uvarint(msg, pos)
        send_ns, pos = _read_uvarint(msg, pos)
        clock, pos = _read_uvarint(msg, pos)
        height, pos = _read_uvarint(msg, pos)
        round1, pos = _read_uvarint(msg, pos)
        olen, pos = _read_uvarint(msg, pos)
        if pos + olen != end or olen > _MAX_ORIGIN_LEN:
            raise ValueError("bad origin length")
        origin = msg[pos:end].decode()
        return TraceCtx(KINDS[kind_id], seq, send_ns, clock, height, round1 - 1, origin), msg[end:]
    except (ValueError, UnicodeDecodeError):
        return None, msg
