"""MConnection: multiplexed, flow-rate-limited message connection.

Parity with reference p2p/conn/connection.go:27-80: byte-ID channels
with send priorities, 1KB packets with EOF reassembly, token-bucket
send/recv rate limiting (default 500 KB/s like the reference), a 10ms
flush throttle, and ping/pong keepalive with a pong timeout. Runs over
a SecretConnection (one packet == one sealed frame).

A copy of the JAX package's ``p2p/conn/connection.py``: the same
packets, channel scheduling and keepalive, byte for byte; each
channel's send queue is the obs plane's instrumented queue, and
``send_queue_stats`` aggregates them for the node's ``p2p.send``
registry entry.
"""

from __future__ import annotations

import asyncio
import struct
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...obs.queues import InstrumentedQueue
from .secret_connection import DATA_MAX_SIZE, SecretConnection

PACKET_PING = 0x01
PACKET_PONG = 0x02
PACKET_MSG = 0x03

FLAG_EOF = 0x01

PACKET_HEADER_SIZE = 5  # type + channel + flags + len(2)
PACKET_PAYLOAD_MAX = DATA_MAX_SIZE - PACKET_HEADER_SIZE

DEFAULT_SEND_RATE = 512_000  # bytes/s (reference: 500 KB/s)
DEFAULT_RECV_RATE = 512_000
DEFAULT_FLUSH_THROTTLE_S = 0.010
DEFAULT_PING_INTERVAL_S = 30.0
DEFAULT_PONG_TIMEOUT_S = 45.0
DEFAULT_SEND_QUEUE_CAPACITY = 1000
DEFAULT_MAX_MSG_SIZE = 10 * 1024 * 1024


class FlowRate:
    """Token-bucket byte-rate limiter (reference libs/flowrate)."""

    def __init__(self, rate: int, burst: Optional[int] = None):
        self.rate = rate
        self.burst = burst if burst is not None else rate
        self.tokens = float(self.burst)
        self.last = time.monotonic()
        self.total = 0

    async def throttle(self, n: int) -> None:
        self.total += n
        while True:
            now = time.monotonic()
            self.tokens = min(
                self.burst, self.tokens + (now - self.last) * self.rate
            )
            self.last = now
            if self.tokens >= n:
                self.tokens -= n
                return
            await asyncio.sleep((n - self.tokens) / self.rate)


@dataclass
class ChannelState:
    chan_id: int
    priority: int = 1
    max_msg_size: int = DEFAULT_MAX_MSG_SIZE
    queue: InstrumentedQueue = field(
        default_factory=lambda: InstrumentedQueue(DEFAULT_SEND_QUEUE_CAPACITY, name="p2p.send")
    )
    sending: bytes = b""  # remainder of the message currently chunking
    recv_buf: bytearray = field(default_factory=bytearray)
    recently_sent: int = 0  # EWMA'd bytes, for priority fairness


@dataclass
class ChannelStatus:
    chan_id: int
    send_queue_size: int
    priority: int


class MConnection:
    """on_receive(chan_id, msg_bytes) is called for each complete
    message; on_error(exc) once when the connection dies."""

    def __init__(
        self,
        sconn: SecretConnection,
        channels: List[tuple],  # (chan_id, priority[, max_msg_size])
        on_receive: Callable,
        on_error: Optional[Callable] = None,
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        flush_throttle_s: float = DEFAULT_FLUSH_THROTTLE_S,
        ping_interval_s: float = DEFAULT_PING_INTERVAL_S,
        pong_timeout_s: float = DEFAULT_PONG_TIMEOUT_S,
    ):
        self.sconn = sconn
        self.channels: Dict[int, ChannelState] = {}
        for desc in channels:
            cid, prio = desc[0], desc[1]
            cs = ChannelState(cid, prio)
            if len(desc) > 2:
                cs.max_msg_size = desc[2]
            self.channels[cid] = cs
        self.on_receive = on_receive
        self.on_error = on_error
        self.send_flow = FlowRate(send_rate)
        self.recv_flow = FlowRate(recv_rate)
        self.flush_throttle_s = flush_throttle_s
        self.ping_interval_s = ping_interval_s
        self.pong_timeout_s = pong_timeout_s
        self._send_wake = asyncio.Event()
        self._pong_pending = asyncio.Event()
        self._last_recv = time.monotonic()
        self._tasks: List[asyncio.Task] = []
        self._closed = False

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._send_routine()),
            asyncio.create_task(self._recv_routine()),
            asyncio.create_task(self._ping_routine()),
        ]

    async def stop(self) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                # bounded (ASY110): a routine that swallows its cancel
                # must not wedge the teardown — the fd close below
                # tears its I/O down regardless
                await asyncio.wait_for(t, 2.0)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                if not t.cancelled():
                    raise  # outer cancel of stop() itself: propagate
            except Exception:
                pass  # routine already reported via _die
        self.sconn.close()

    def abort(self) -> None:
        """Synchronous last-resort close: cancel the routines and close
        the fd WITHOUT awaiting anything. An abandoned graceful stop must still kill
        the socket — a conn left open past shutdown is a zombie the
        remote keeps treating as a live peer (it then dup-discards the
        restarted node's fresh dials and the node can never rejoin)."""
        self._closed = True
        for t in self._tasks:
            t.cancel()
        try:
            self.sconn.close()
        except Exception:
            pass

    def inject_error(self, exc: Exception) -> None:
        """Fault-injection hook (chaos ``reconnect_storm`` /
        ``conn_kill``): kill the connection exactly the way an
        internal routine failure does — e.g. a pong timeout
        (``_ping_routine``) — driving the owner's on_error path and,
        for persistent peers, the self-healing reconnect plane. The
        remote side observes the close as a read error, so BOTH ends
        exercise their conn-death handling."""
        self._die(exc)

    def _die(self, exc: Exception) -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._tasks:
            if t is not asyncio.current_task():
                t.cancel()
        self.sconn.close()
        if self.on_error:
            try:
                self.on_error(exc)
            except Exception:
                traceback.print_exc()

    # --- sending ------------------------------------------------------

    async def send(self, chan_id: int, msg: bytes) -> bool:
        """Queue a message; blocks if the channel queue is full."""
        ch = self.channels.get(chan_id)
        if ch is None or self._closed:
            return False
        await ch.queue.put(bytes(msg))
        self._send_wake.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Queue a message without blocking; False if full/unknown."""
        ch = self.channels.get(chan_id)
        if ch is None or self._closed:
            return False
        try:
            ch.queue.put_nowait(bytes(msg))
        except asyncio.QueueFull:
            ch.queue.count_drop()  # shed under overload, counted
            return False
        self._send_wake.set()
        return True

    def _next_packet(self) -> Optional[bytes]:
        """Pick the channel with the least recently-sent bytes per unit
        priority (reference sendPacketMsg) and cut one packet."""
        best: Optional[ChannelState] = None
        best_score = None
        for ch in self.channels.values():
            if not ch.sending and ch.queue.empty():
                continue
            score = ch.recently_sent / max(ch.priority, 1)
            if best is None or score < best_score:
                best, best_score = ch, score
        if best is None:
            return None
        if not best.sending:
            best.sending = best.queue.get_nowait()
        chunk = best.sending[:PACKET_PAYLOAD_MAX]
        best.sending = best.sending[PACKET_PAYLOAD_MAX:]
        eof = FLAG_EOF if not best.sending else 0
        pkt = (
            struct.pack(
                ">BBBH", PACKET_MSG, best.chan_id, eof, len(chunk)
            )
            + chunk
        )
        best.recently_sent += len(pkt)
        return pkt

    async def _send_routine(self) -> None:
        try:
            while not self._closed:
                pkt = self._next_packet()
                if pkt is None:
                    # decay fairness counters while idle
                    for ch in self.channels.values():
                        ch.recently_sent = int(ch.recently_sent * 0.8)
                    try:
                        await asyncio.wait_for(
                            self._send_wake.wait(), self.flush_throttle_s * 10
                        )
                    except asyncio.TimeoutError:
                        continue
                    self._send_wake.clear()
                    continue
                n = await self.sconn.write_msg(pkt)
                await self.send_flow.throttle(n)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    # --- receiving ----------------------------------------------------

    async def _recv_routine(self) -> None:
        try:
            while not self._closed:
                chunk = await self.sconn.read_chunk()
                self._last_recv = time.monotonic()
                await self.recv_flow.throttle(len(chunk) + 16)
                if not chunk:
                    continue
                ptype = chunk[0]
                if ptype == PACKET_PING:
                    await self.sconn.write_msg(bytes([PACKET_PONG]))
                elif ptype == PACKET_PONG:
                    self._pong_pending.set()
                elif ptype == PACKET_MSG:
                    self._handle_msg_packet(chunk)
                else:
                    raise ValueError(f"unknown packet type {ptype}")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    def _handle_msg_packet(self, pkt: bytes) -> None:
        _, cid, flags, ln = struct.unpack(">BBBH", pkt[:PACKET_HEADER_SIZE])
        data = pkt[PACKET_HEADER_SIZE : PACKET_HEADER_SIZE + ln]
        ch = self.channels.get(cid)
        if ch is None:
            raise ValueError(f"packet for unknown channel {cid:#x}")
        ch.recv_buf.extend(data)
        if len(ch.recv_buf) > ch.max_msg_size:
            raise ValueError(
                f"message on channel {cid:#x} exceeds {ch.max_msg_size}"
            )
        if flags & FLAG_EOF:
            msg = bytes(ch.recv_buf)
            ch.recv_buf.clear()
            self.on_receive(cid, msg)

    # --- keepalive ----------------------------------------------------

    async def _ping_routine(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(self.ping_interval_s)
                self._pong_pending.clear()
                await self.sconn.write_msg(bytes([PACKET_PING]))
                try:
                    await asyncio.wait_for(
                        self._pong_pending.wait(), self.pong_timeout_s
                    )
                except asyncio.TimeoutError:
                    raise ConnectionError("pong timeout")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._die(e)

    # --- introspection ------------------------------------------------

    def status(self) -> List[ChannelStatus]:
        return [
            ChannelStatus(c.chan_id, c.queue.qsize(), c.priority)
            for c in self.channels.values()
        ]

    def send_queue_stats(self) -> dict:
        """Aggregate backpressure telemetry over every channel's send
        queue (obs/queues.py semantics: depth summed, watermark is
        the worst single channel, drops summed)."""
        depth = hwm = dropped = enqueued = 0
        for ch in self.channels.values():
            q = ch.queue
            depth += q.qsize()
            hwm = max(hwm, q.high_watermark)
            dropped += q.dropped
            enqueued += q.enqueued
        # aggregate entry: no "maxsize" (summed depth must not be
        # compared against the per-channel bound by health's
        # full-queue check)
        return {
            "depth": depth,
            "high_watermark": hwm,
            "dropped": dropped,
            "enqueued": enqueued,
            "per_channel_maxsize": DEFAULT_SEND_QUEUE_CAPACITY,
        }
