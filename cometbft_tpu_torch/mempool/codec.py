"""Channel-0x30 tx gossip framing: length-prefixed batches with
single-tx backward compatibility. A copy of the JAX package's
``mempool/codec.py``.

Historically a mempool message WAS the raw tx bytes. Batching needs a
frame, so batch messages open with a 2-byte magic followed by a
varint tx count and length-prefixed txs:

    MAGIC(2) | uvarint(count>=1) | { uvarint(len) | tx }*count

Compatibility contract, both directions:

- ``encode_txs([tx])`` emits the RAW tx (old wire form) unless the tx
  itself begins with MAGIC, in which case it is escaped as a batch of
  one — so a new receiver can always tell the two apart.
- ``decode_txs`` treats anything not starting with MAGIC as a raw
  single tx, and falls back to raw-single-tx on ANY parse failure
  after the magic — an old peer relaying a tx that happens to begin
  with the magic bytes still gets through (a malformed-but-magic
  message then fails CheckTx like any garbage tx would).
"""

from __future__ import annotations

from typing import List

# 0x30 echoes the mempool channel id; 0xB7 is arbitrary non-ASCII
MAGIC = b"\xb7\x30"

# decode hard caps: a frame is at most one channel message (1 MiB
# descriptor), so anything claiming more items than bytes is garbage
_MAX_BATCH_TXS = 1 << 20


def _put_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_uvarint(buf: bytes, pos: int) -> "tuple[int, int]":
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


def encode_batch(txs: List[bytes]) -> bytes:
    """Always-framed batch (len >= 1)."""
    if not txs:
        raise ValueError("empty tx batch")
    out = bytearray(MAGIC)
    _put_uvarint(out, len(txs))
    for tx in txs:
        _put_uvarint(out, len(tx))
        out += tx
    return bytes(out)


def encode_txs(txs: List[bytes]) -> bytes:
    """Wire form for a gossip send: raw bytes for a lone
    non-magic-prefixed tx (old wire form, old peers keep working),
    a batch frame otherwise."""
    if len(txs) == 1 and not txs[0].startswith(MAGIC):
        return txs[0]
    return encode_batch(txs)


def decode_txs(msg: bytes) -> List[bytes]:
    """Txs carried by one channel-0x30 message (see module doc)."""
    if not msg.startswith(MAGIC):
        return [msg]
    try:
        pos = len(MAGIC)
        count, pos = _read_uvarint(msg, pos)
        if count < 1 or count > min(_MAX_BATCH_TXS, len(msg)):
            raise ValueError("implausible batch count")
        txs = []
        for _ in range(count):
            ln, pos = _read_uvarint(msg, pos)
            if pos + ln > len(msg):
                raise ValueError("truncated tx")
            txs.append(msg[pos:pos + ln])
            pos += ln
        if pos != len(msg):
            raise ValueError("trailing bytes after batch")
        return txs
    except ValueError:
        # old peer relaying a raw tx that starts with our magic
        return [msg]
