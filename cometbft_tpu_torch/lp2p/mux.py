"""Stream multiplexer over a SecretConnection (yamux-flavored).

Frames ride inside the encrypted channel; each frame is

    stream_id:u32 | flag:u8 | length:u32 | payload[length]

flags: SYN opens a stream (payload = protocol id, utf-8), DATA carries
one complete message (the mux is message-oriented like the reference's
length-prefixed libp2p streams, not byte-oriented), FIN half-closes,
RST aborts, PING/PONG keep the connection alive. Stream-id parity
avoids open collisions: the connection initiator allocates odd ids,
the accepter even ids (reference analog: yamux under go-libp2p).

A copy of the JAX package's ``lp2p/mux.py``; frames are byte-identical,
so a port peer and a JAX peer share one muxed connection. Inbound
overflow drops on gossip streams (counted in ``MuxStream.dropped``) and
kills the connection on request/response streams (``overflow_fatal``);
``overflow_kills`` counts the latter by protocol.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Callable, Dict, Optional

from ..utils.log import get_logger

_log = get_logger("lp2p.mux")

SYN, DATA, FIN, RST, PING, PONG = range(6)
_HDR = struct.Struct(">IBI")

MAX_FRAME_PAYLOAD = 16 * 1024 * 1024
DEFAULT_STREAM_QUEUE = 256
PING_INTERVAL_S = 20.0
PONG_TIMEOUT_S = 45.0


class MuxError(Exception):
    pass


class MuxStream:
    """One logical stream: ordered message queue in, writes out via
    the shared muxer."""

    def __init__(self, mux: "Muxer", stream_id: int, protocol: str):
        qsize = getattr(mux, "stream_queue", DEFAULT_STREAM_QUEUE)
        self.mux = mux
        self.stream_id = stream_id
        self.protocol = protocol
        self.recv_q: asyncio.Queue = asyncio.Queue(qsize)
        self.closed = False
        self.reset = False
        self.dropped = 0  # inbound messages discarded on queue overflow

    async def send(self, msg: bytes) -> None:
        if self.closed:
            raise MuxError(f"stream {self.stream_id} closed")
        await self.mux._send_frame(self.stream_id, DATA, msg)

    def try_send(self, msg: bytes) -> bool:
        """Best-effort enqueue; False when the connection's outbound
        queue is saturated (caller drops, matching Peer.try_send)."""
        if self.closed:
            return False
        return self.mux._try_send_frame(self.stream_id, DATA, msg)

    async def recv(self) -> Optional[bytes]:
        """Next message, or None at clean EOF."""
        if self.closed and self.recv_q.empty():
            return None
        msg = await self.recv_q.get()
        return msg  # None sentinel = FIN/RST

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                # bounded: the FIN is a courtesy — a dead conn must
                # not hang the stream close
                await asyncio.wait_for(
                    self.mux._send_frame(self.stream_id, FIN, b""), 2.0
                )
            except asyncio.CancelledError:
                raise
            except (asyncio.TimeoutError, OSError, RuntimeError):
                pass  # dead conn: the FIN courtesy just didn't land
            self.mux._drop_stream(self.stream_id)

    def abort(self) -> None:
        if not self.closed:
            self.closed = True
            self.reset = True
            self.mux._try_send_frame(self.stream_id, RST, b"")
            self.mux._drop_stream(self.stream_id)
            try:  # wake a reader blocked on an (empty) queue
                self.recv_q.put_nowait(None)
            except asyncio.QueueFull:
                pass


class Muxer:
    """Multiplexes MuxStreams over one SecretConnection.

    on_stream(stream) fires for every remotely-opened stream after its
    SYN arrives. on_error(exc) fires once when the connection dies.
    """

    def __init__(
        self,
        sconn,
        initiator: bool,
        on_stream: Callable[[MuxStream], None],
        on_error: Optional[Callable[[Exception], None]] = None,
        max_streams: int = 64,
        send_queue: int = 1024,
        send_rate: int = 0,
        recv_rate: int = 0,
        stream_queue: int = DEFAULT_STREAM_QUEUE,
        overflow_fatal: Optional[Callable[[str], bool]] = None,
    ):
        self.sconn = sconn
        self.streams: Dict[int, MuxStream] = {}
        self.on_stream = on_stream
        self.on_error = on_error
        # predicate by protocol id: True -> inbound queue overflow is
        # fatal to the CONNECTION (request/response channels, where a
        # dropped reply stalls the requester until timeout and a
        # stream-level reset would leave the remote's outbound stream
        # dead); False -> count the drop (gossip channels re-send)
        self.overflow_fatal = overflow_fatal or (lambda _proto: False)
        self.max_streams = max_streams
        self.stream_queue = stream_queue
        self._initiator = initiator
        self._next_id = 1 if initiator else 2
        self._send_q: asyncio.Queue = asyncio.Queue(send_queue)
        self._tasks = []
        self._dead = False
        self._pong = asyncio.Event()
        self.sent_bytes = 0
        self.recv_bytes = 0
        # protocol -> connections this muxer killed on its overflow
        self.overflow_kills: Dict[str, int] = {}
        # operator bandwidth caps apply to the lp2p stack too (the
        # native stack throttles inside MConnection); 0 = unlimited
        from ..p2p.conn.connection import FlowRate

        self._send_flow = FlowRate(send_rate) if send_rate > 0 else None
        self._recv_flow = FlowRate(recv_rate) if recv_rate > 0 else None

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._send_routine()),
            asyncio.create_task(self._recv_routine()),
            asyncio.create_task(self._ping_routine()),
        ]

    async def stop(self) -> None:
        self._dead = True
        for s in list(self.streams.values()):
            s.closed = True
        self.streams.clear()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                # bounded: a routine swallowing its cancel must not
                # wedge stop — the fd close below kills its I/O anyway
                await asyncio.wait_for(t, 2.0)
            except asyncio.CancelledError:
                pass  # we cancelled t ourselves two lines up
            except Exception:
                pass  # routine died on a torn conn; fd close follows
        self.sconn.close()

    # --- stream open --------------------------------------------------

    def _alloc_stream(self, protocol: str) -> MuxStream:
        if self._dead:
            raise MuxError("muxer closed")
        if len(self.streams) >= self.max_streams:
            raise MuxError("stream limit reached")
        sid = self._next_id
        self._next_id += 2
        if sid in self.streams:  # unreachable with parity enforcement
            raise MuxError(f"stream id {sid} already in use")
        st = MuxStream(self, sid, protocol)
        self.streams[sid] = st
        return st

    async def open_stream(self, protocol: str) -> MuxStream:
        st = self._alloc_stream(protocol)
        await self._send_frame(st.stream_id, SYN, protocol.encode())
        return st

    def open_stream_nowait(self, protocol: str) -> MuxStream:
        """Synchronous open: enqueue the SYN without awaiting, so
        callers can hand out usable streams before yielding to the
        loop (peers must be sendable the moment reactors see them).
        Raises MuxError if the send queue is full (only possible on an
        already-saturated connection)."""
        st = self._alloc_stream(protocol)
        if not self._try_send_frame(st.stream_id, SYN, protocol.encode()):
            self._drop_stream(st.stream_id)
            raise MuxError("send queue full during stream open")
        return st

    # --- framing ------------------------------------------------------

    async def _send_frame(self, sid: int, flag: int, payload: bytes):
        if self._dead:
            raise MuxError("muxer closed")
        await self._send_q.put(_HDR.pack(sid, flag, len(payload)) + payload)

    def _try_send_frame(self, sid: int, flag: int, payload: bytes) -> bool:
        if self._dead:
            return False
        try:
            self._send_q.put_nowait(
                _HDR.pack(sid, flag, len(payload)) + payload
            )
            return True
        except asyncio.QueueFull:
            return False

    def _drop_stream(self, sid: int) -> None:
        self.streams.pop(sid, None)

    def _die(self, exc: Exception) -> None:
        if self._dead:
            return
        self._dead = True
        for s in list(self.streams.values()):
            s.closed = True
            try:
                s.recv_q.put_nowait(None)
            except asyncio.QueueFull:
                pass
        if self.on_error:
            self.on_error(exc)

    # --- routines -----------------------------------------------------

    async def _send_routine(self) -> None:
        try:
            while True:
                frame = await self._send_q.get()
                if self._send_flow is not None:
                    await self._send_flow.throttle(len(frame))
                self.sent_bytes += len(frame)
                await self.sconn.write_msg(frame)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    async def _recv_routine(self) -> None:
        # bytearray + consume offset: appending chunks and slicing the
        # head stays O(bytes) per frame (repeated bytes concatenation
        # over ~1KB SecretConnection chunks would be O(n^2))
        buf = bytearray()
        pos = 0
        try:
            while True:
                while len(buf) - pos < _HDR.size:
                    buf += await self._read()
                sid, flag, n = _HDR.unpack_from(buf, pos)
                if n > MAX_FRAME_PAYLOAD:
                    raise MuxError(f"oversized frame ({n} bytes)")
                pos += _HDR.size
                while len(buf) - pos < n:
                    buf += await self._read()
                payload = bytes(buf[pos : pos + n])
                pos += n
                if pos > 1 << 16:
                    del buf[:pos]
                    pos = 0
                self._handle(sid, flag, payload)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    async def _read(self) -> bytes:
        chunk = await self.sconn.read_chunk()
        if not chunk:
            raise MuxError("connection closed")
        if self._recv_flow is not None:
            await self._recv_flow.throttle(len(chunk))
        self.recv_bytes += len(chunk)
        return chunk

    def _handle(self, sid: int, flag: int, payload: bytes) -> None:
        if flag == SYN:
            # a remote-opened stream must carry the REMOTE side's id
            # parity (initiator odd / accepter even); without this a
            # peer could pre-register an id in our allocator's space
            # and cross-wire a later local stream onto its frames
            remote_parity = 0 if self._initiator else 1
            if (
                sid % 2 != remote_parity
                or sid in self.streams
                or len(self.streams) >= self.max_streams
            ):
                self._try_send_frame(sid, RST, b"")
                return
            st = MuxStream(self, sid, payload.decode("utf-8", "replace"))
            self.streams[sid] = st
            try:
                self.on_stream(st)
            except Exception:
                st.abort()
        elif flag == DATA:
            st = self.streams.get(sid)
            if st is None:
                return  # late data on a dropped stream
            try:
                st.recv_q.put_nowait(payload)
            except asyncio.QueueFull:
                st.dropped += 1
                if self.overflow_fatal(st.protocol):
                    # request/response channel: a silently dropped
                    # reply leaves the requester stalled until its
                    # timeout, and a stream-level RST would leave the
                    # remote's outbound stream dead for the rest of the
                    # connection — kill the CONNECTION so the error
                    # surfaces and the switch's reconnect logic
                    # restores a clean channel set (the native stack's
                    # MConnection does the same on queue overflow)
                    self.overflow_kills[st.protocol] = self.overflow_kills.get(st.protocol, 0) + 1
                    _log.error(
                        "inbound queue overflow on request/response "
                        "channel, dropping connection",
                        protocol=st.protocol,
                        stream=sid,
                    )
                    self._die(
                        MuxError(
                            f"inbound overflow on {st.protocol}"
                        )
                    )
                elif st.dropped == 1:
                    # gossip channels re-send: drop, but surface the
                    # first occurrence per stream
                    _log.info(
                        "inbound queue overflow, dropping message",
                        protocol=st.protocol,
                        stream=sid,
                    )
        elif flag in (FIN, RST):
            st = self.streams.pop(sid, None)
            if st is not None:
                st.closed = True
                st.reset = flag == RST
                try:
                    st.recv_q.put_nowait(None)
                except asyncio.QueueFull:
                    pass
        elif flag == PING:
            self._try_send_frame(0, PONG, b"")
        elif flag == PONG:
            self._pong.set()

    async def _ping_routine(self) -> None:
        try:
            while True:
                await asyncio.sleep(PING_INTERVAL_S)
                self._pong.clear()
                self._try_send_frame(0, PING, b"")
                try:
                    await asyncio.wait_for(
                        self._pong.wait(), PONG_TIMEOUT_S
                    )
                except asyncio.TimeoutError:
                    raise MuxError("ping timeout")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)
