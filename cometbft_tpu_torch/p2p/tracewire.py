"""Cross-node trace-context stamping for p2p messages (a copy of the
JAX package's ``p2p/tracewire.py``; docs/TRACE.md "Cross-node
timelines").

Consensus, mempool-gossip and blocksync messages can ride the wire
with a compact causal context — origin node, message kind, height /
round, origin send timestamp (monotonic ns), origin clock-domain id
and a per-origin sequence number — so each receiver can record a
correlated receive instant in its own trace ring and the offline
timeline tool (trace/timeline.py) can stitch every node's ring into
one causally-ordered view.

Wire form mirrors the mempool gossip codec (mempool/codec.py):
the stamp is an OPTIONAL magic-prefixed header in front of the
otherwise-unchanged reactor message:

    MAGIC(2) | uvarint(hdr_len >= 1) | hdr | payload      stamped
    MAGIC(2) | 0x00                  | payload            escape
    payload                                               unstamped

    hdr = uvarint(kind_id) | uvarint(seq) | uvarint(send_ns)
        | uvarint(clock) | uvarint(height) | uvarint(round + 1)
        | uvarint(len(origin)) | origin-utf8

Compatibility contract, both directions (tests/test_torch_tracewire.py):

- ``unstamp`` treats anything not starting with MAGIC as a raw
  unstamped message, and falls back to raw on ANY parse failure after
  the magic — an old peer relaying a message that happens to begin
  with the magic bytes still decodes losslessly.
- a stamping-disabled sender that must emit a payload beginning with
  MAGIC escapes it as a zero-length header frame, so a new receiver
  can always tell the two apart; ``unstamp(stamp(m)) == m`` and
  ``unstamp(escape(m)) == m`` for every payload.

Timestamps here are ``time.monotonic_ns`` of the ORIGIN — meaningful
to a receiver only inside the same clock domain (one process).
``clock`` carries a random per-process domain id so receivers compute
live propagation only when the clocks actually compare; cross-process
correlation instead goes through each ring's monotonic→wall anchor
(recorded at tracer build, node/inprocess.py) in the timeline tool.
The wire bytes equal the JAX package's for equal inputs, so stamped
traffic between port and JAX nodes correlates both ways.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional, Tuple

_monotonic_ns = time.monotonic_ns

# 0xB7 echoes the mempool codec's non-ASCII lead byte; 0x54 = "T"
MAGIC = b"\xb7\x54"

# message kinds a stamp may carry (wire ids are positional — append
# only; an unknown id on decode falls back to raw, like any parse
# failure, so old receivers never misread new kinds)
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
_KIND_ID = {k: i for i, k in enumerate(KINDS)}

# per-process clock-domain id (nonzero): receivers compute live
# propagation deltas only when the sender's domain matches their own
CLOCK_DOMAIN = int.from_bytes(os.urandom(4), "big") | 1

# worst-case stamp size (magic + len + full header with a long
# origin): senders near a channel's max_msg_size skip the stamp
# rather than cross the cap (same guard as the mempool batch escape)
STAMP_MAX_OVERHEAD = 64

_MAX_ORIGIN_LEN = 32


class TraceCtx:
    """Decoded stamp: who sent this message, about what, and when
    (origin monotonic ns)."""

    __slots__ = ("kind", "seq", "send_ns", "clock", "height", "round",
                 "origin")

    def __init__(self, kind, seq, send_ns, clock, height, round_, origin):
        self.kind = kind
        self.seq = seq
        self.send_ns = send_ns
        self.clock = clock
        self.height = height
        self.round = round_
        self.origin = origin

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceCtx({self.kind} h={self.height} r={self.round} "
            f"seq={self.seq} from={self.origin})"
        )


def _put_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


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


def stamp(
    payload: bytes,
    kind: str,
    seq: int,
    origin: str,
    height: int = 0,
    round_: int = -1,
    send_ns: Optional[int] = None,
    clock: int = CLOCK_DOMAIN,
) -> bytes:
    """Prefix ``payload`` with a trace-context header."""
    hdr = bytearray()
    _put_uvarint(hdr, _KIND_ID[kind])
    _put_uvarint(hdr, seq)
    _put_uvarint(hdr, send_ns if send_ns is not None else _monotonic_ns())
    _put_uvarint(hdr, clock)
    _put_uvarint(hdr, max(0, height))
    _put_uvarint(hdr, round_ + 1)  # -1 (no round) encodes as 0
    o = origin.encode()[:_MAX_ORIGIN_LEN]
    _put_uvarint(hdr, len(o))
    hdr += o
    out = bytearray(MAGIC)
    _put_uvarint(out, len(hdr))
    out += hdr
    out += payload
    return bytes(out)


def escape(payload: bytes) -> bytes:
    """Zero-header frame: a stamping-disabled sender whose payload
    happens to begin with MAGIC wraps it so the receiver cannot
    misparse it as a stamp."""
    return MAGIC + b"\x00" + payload


def encode_plain(payload: bytes, cap: int = 0) -> bytes:
    """Wire form for an unstamped send: raw bytes, escaping only the
    (vanishingly rare) MAGIC-prefixed payload so the receiver's
    always-on peel cannot mutate it. ``cap`` is the channel's max
    message size: a magic-prefixed payload within 3 bytes of the cap
    goes out raw rather than oversized — the one remaining aliasing
    window (cap-sized AND magic-prefixed AND header-parseable) is
    vanishingly small, the same compromise the mempool batch codec
    makes for its own oversize escape."""
    if payload.startswith(MAGIC) and (
        not cap or len(payload) + len(MAGIC) + 1 <= cap
    ):
        return escape(payload)
    return payload


def unstamp(msg: bytes) -> Tuple[Optional[TraceCtx], bytes]:
    """(ctx-or-None, payload). Anything unparseable — including an
    old peer's raw message that happens to begin with MAGIC — comes
    back as (None, msg) unchanged."""
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
        return (
            TraceCtx(
                KINDS[kind_id], seq, send_ns, clock, height,
                round1 - 1, origin,
            ),
            msg[end:],
        )
    except (ValueError, UnicodeDecodeError):
        # old peer relaying raw bytes that start with our magic
        return None, msg


class TraceStamper:
    """Per-switch stamping plane: wraps outbound messages with a
    trace context and records correlated send/recv instants in the
    node's ring (docs/TRACE.md "Cross-node timelines").

    Built by the node wiring whenever the tracer is enabled;
    ``Switch`` holds ``stamper = None`` otherwise, so the fully-off
    path is one attribute check per send and a startswith per
    receive. ``outbound`` mirrors ``[instrumentation]
    trace_msg_stamp``: False stops this node stamping its own sends
    while receive-side correlation (``on_receive``) keeps recording
    arrivals from stamping peers — decode is always on.
    """

    __slots__ = ("tracer", "origin", "outbound", "_seq")

    def __init__(self, tracer, origin: str, outbound: bool = True):
        self.tracer = tracer
        self.origin = origin
        self.outbound = outbound
        # per-origin sequence: the recv-side correlation key
        self._seq = itertools.count()

    def wrap(
        self,
        payload: bytes,
        kind: str,
        height: int = 0,
        round_: int = -1,
        cap: int = 0,
        peer: str = "",
        npeers: int = 0,
    ) -> bytes:
        """Stamp + record a ``p2p.msg.send`` instant. ``cap`` is the
        channel's max message size: a payload too close to it goes out
        unstamped (escaped if magic-prefixed) rather than oversized."""
        if cap and len(payload) + STAMP_MAX_OVERHEAD > cap:
            return encode_plain(payload, cap)
        seq = next(self._seq)
        send_ns = _monotonic_ns()
        wire = stamp(
            payload, kind, seq, self.origin,
            height=height, round_=round_, send_ns=send_ns,
        )
        args = {"kind": kind, "h": height, "r": round_, "seq": seq}
        if peer:
            args["peer"] = peer
        if npeers:
            args["n"] = npeers
        self.tracer.instant_at("p2p.msg.send", send_ns, tid="p2p", **args)
        return wire

    def on_receive(self, ctx: TraceCtx, peer_id: str) -> None:
        """Record the correlated receive instant (+ a live propagation
        span when the sender shares our clock domain)."""
        tr = self.tracer
        if not tr.enabled:
            return
        recv_ns = _monotonic_ns()
        tr.instant_at(
            "p2p.msg.recv", recv_ns, tid="p2p",
            kind=ctx.kind, h=ctx.height, r=ctx.round, seq=ctx.seq,
            origin=ctx.origin, send_ns=ctx.send_ns, peer=peer_id[:12],
        )
        if ctx.clock == CLOCK_DOMAIN:
            dur = recv_ns - ctx.send_ns
            if dur >= 0:
                tr.complete(
                    "p2p.msg.propagation", ctx.send_ns, dur, tid="p2p",
                    kind=ctx.kind, origin=ctx.origin, h=ctx.height,
                )
