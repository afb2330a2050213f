"""Lp2pSwitch: the alternative Switcher over stream-multiplexed conns.

Reference analog: `lp2p.Switch` (`lp2p/switch.go:25,56`) — the second
implementation of `p2p.Switcher` (`p2p/switcher.go:12`) selected by
config at `node/node.go:476-575`. Each legacy channel byte maps to its
own protocol / stream pair (`lp2p/stream.go:28`), and inbound reactor
messages drain through the auto-scaling worker pool
(`lp2p/reactor_set.go` + `internal/autopool`).

Implementation note: peer lifecycle (dial, reconnect-with-backoff,
ban, reactor registry, broadcast) is shared with the native Switch by
subclassing — both stacks satisfy the same Switcher contract and only
differ in what is layered over the encrypted connection (per-channel
mux streams here, a single MConnection there) and in admission (Host
gater + resource manager here). In particular the persistent-peer
reconnect path backs off through the one shared policy in
utils/backoff.py (exponential + full jitter + cap) rather than a
second hand-rolled schedule.

A copy of the JAX package's ``lp2p/switch.py`` over the port's
``Switch``: the admission slot the Host took is released wherever the
port's base drops a conn or a peer (``_discard_conn``, ``_remove_peer``,
``_evict_peer_sync``), and a ban feeds the gater. The base keeps the
port's C3 rule: a reactor's ``DeviceRouteError`` is counted, not a
reason to drop the peer.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional

from ..p2p.node_info import NodeInfo
from ..p2p.switch import Switch
from .host import ConnGater, Host, ResourceManager
from .mux import DEFAULT_STREAM_QUEUE, Muxer, MuxStream

PROTOCOL_PREFIX = "/cometbft/ch/"


def channel_protocol(chan_id: int) -> str:
    """Legacy channel byte -> protocol id (reference lp2p/stream.go:28)."""
    return f"{PROTOCOL_PREFIX}{chan_id:#04x}"


def protocol_channel(protocol: str) -> Optional[int]:
    if not protocol.startswith(PROTOCOL_PREFIX):
        return None
    try:
        return int(protocol[len(PROTOCOL_PREFIX):], 16)
    except ValueError:
        return None


# Channels whose messages are request/response pairs (blocksync block
# responses 0x40, statesync snapshot 0x60 / chunk 0x61 responses): a
# reply dropped on inbound-queue overflow would stall the requester
# until its timeout, so overflow is FATAL TO THE CONNECTION — the peer
# drops and (if persistent) reconnects with a clean channel set. A
# stream-level reset would leave the remote's outbound stream dead for
# the connection's lifetime; gossip channels keep drop semantics.
REQRESP_CHANNELS = frozenset({0x40, 0x60, 0x61})


def _overflow_fatal(protocol: str) -> bool:
    return protocol_channel(protocol) in REQRESP_CHANNELS


class Lp2pPeer:
    """Peer over a Muxer: one outbound stream per registered channel
    (opened at start), inbound streams dispatched by protocol id.
    Interface-compatible with p2p.Peer."""

    def __init__(
        self,
        sconn,
        node_info: NodeInfo,
        conn_str: str,
        channels: List[tuple],  # (chan_id, priority, max_msg_size)
        on_receive,  # (chan_id, msg, peer)
        on_error=None,  # (peer, exc)
        outbound: bool = False,
        persistent: bool = False,
        max_streams: int = 64,
        stream_queue: int = 0,
        send_rate: int = 0,
        recv_rate: int = 0,
    ):
        self.node_info = node_info
        self.conn_str = conn_str
        self.outbound = outbound
        self.persistent = persistent
        self._data: Dict[str, Any] = {}
        self._on_receive = on_receive
        self._on_error = on_error
        self._max_msg_size = {c[0]: c[2] for c in channels}
        self._chan_ids = [c[0] for c in channels]
        self._out: Dict[int, MuxStream] = {}
        self._ready = asyncio.Event()
        self._reader_tasks: List[asyncio.Task] = []
        self._start_task: Optional[asyncio.Task] = None
        self._stopped = False
        self.mux = Muxer(
            sconn,
            initiator=outbound,
            on_stream=self._on_stream,
            on_error=self._mux_error,
            max_streams=max_streams,
            stream_queue=stream_queue or DEFAULT_STREAM_QUEUE,
            send_rate=send_rate,
            recv_rate=recv_rate,
            overflow_fatal=_overflow_fatal,
        )

    # --- identity -----------------------------------------------------

    @property
    def peer_id(self) -> str:
        return self.node_info.node_id

    def __repr__(self) -> str:
        return f"Lp2pPeer({self.peer_id[:10]}@{self.conn_str})"

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        self.mux.start()
        # open channel streams synchronously (SYNs enqueue without
        # awaiting): reactors call add_peer right after start() and
        # must be able to try_send immediately — e.g. statesync's
        # one-shot snapshots request would otherwise be silently lost
        try:
            for cid in self._chan_ids:
                self._out[cid] = self.mux.open_stream_nowait(
                    channel_protocol(cid)
                )
            self._ready.set()
        except Exception as e:
            self._mux_error(e)

    async def stop(self) -> None:
        self._stopped = True
        if self._start_task:
            self._start_task.cancel()
        for t in self._reader_tasks:
            t.cancel()
        try:
            # bounded: mux.stop is internally bounded; this keeps a
            # hung conn from wedging the whole switch stop
            await asyncio.wait_for(self.mux.stop(), 5.0)
        except asyncio.TimeoutError:
            pass

    def abort(self) -> None:
        """Synchronous last-resort close (never awaits): see
        p2p MConnection.abort — an abandoned stop must still kill the
        underlying fd or the remote keeps a zombie peer entry."""
        self._stopped = True
        if self._start_task:
            self._start_task.cancel()
        for t in self._reader_tasks:
            t.cancel()
        for t in self.mux._tasks:
            t.cancel()
        try:
            self.mux.sconn.close()
        except Exception:
            pass

    def _mux_error(self, exc: Exception) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._on_error:
            self._on_error(self, exc)

    def inject_error(self, exc: Exception) -> None:
        """Chaos hook (parity with p2p.Peer.inject_error): die as if
        ``exc`` came from a mux routine, driving the switch's
        on_error -> reconnect path."""
        self._mux_error(exc)

    # --- inbound ------------------------------------------------------

    def _on_stream(self, st: MuxStream) -> None:
        cid = protocol_channel(st.protocol)
        if cid is None or cid not in self._max_msg_size:
            st.abort()
            return
        # drop finished readers first: streams come and go for the
        # peer's whole lifetime, and a done task kept in the list is
        # a leak
        self._reader_tasks = [
            t for t in self._reader_tasks if not t.done()
        ]
        self._reader_tasks.append(
            asyncio.create_task(self._read_stream(cid, st))
        )

    async def _read_stream(self, cid: int, st: MuxStream) -> None:
        limit = self._max_msg_size[cid]
        try:
            while True:
                msg = await st.recv()
                if msg is None:
                    return
                if len(msg) > limit:
                    raise ValueError(
                        f"message exceeds channel {cid:#x} limit {limit}"
                    )
                self._on_receive(cid, msg, self)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._mux_error(e)

    # --- outbound -----------------------------------------------------

    async def send(self, chan_id: int, msg: bytes) -> bool:
        try:
            await asyncio.wait_for(self._ready.wait(), 10.0)
            await self._out[chan_id].send(msg)
            return True
        except asyncio.CancelledError:
            raise  # peer stop cancels senders; never report "sent"
        except Exception:
            return False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        st = self._out.get(chan_id)
        if st is None:
            return False  # streams still opening
        return st.try_send(msg)

    # --- traffic totals (uniform across peer implementations) ---------

    @property
    def recv_total(self) -> int:
        return self.mux.recv_bytes

    @property
    def send_total(self) -> int:
        return self.mux.sent_bytes

    # --- per-peer reactor state ---------------------------------------

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value


class Lp2pSwitch(Switch):
    """Switcher implementation over Host + Muxer.

    Defaults to autopool draining (the reference's lp2p reactor set
    always drains through autopool workers)."""

    def __init__(
        self,
        transport,
        node_info: NodeInfo,
        max_peers: int = 50,
        rcmgr: Optional[ResourceManager] = None,
        gater: Optional[ConnGater] = None,
        use_autopool: bool = True,
        send_rate: int = 0,
        recv_rate: int = 0,
        reconnect_config: Optional[dict] = None,
    ):
        host = Host(transport, rcmgr=rcmgr, gater=gater)
        super().__init__(
            host, node_info, max_peers=max_peers,
            use_autopool=use_autopool,
            reconnect_config=reconnect_config,
        )
        self.host = host
        self.send_rate = send_rate
        self.recv_rate = recv_rate

    def _discard_conn(self, sconn) -> None:
        # the Host admitted this conn (rcmgr.acquire_conn); a rejection
        # above the Host must release the slot or churn from banned /
        # duplicate peers permanently exhausts admission capacity
        super()._discard_conn(sconn)
        self.host.conn_closed()

    def _make_peer(
        self, sconn, their_info, conn_str, outbound, persistent=False
    ) -> Lp2pPeer:
        channels = [
            (d.chan_id, d.priority, d.max_msg_size)
            for d in self.channel_descs
        ]
        peer = Lp2pPeer(
            sconn,
            their_info,
            conn_str,
            channels,
            on_receive=self._on_peer_msg,
            on_error=self._on_peer_error,
            outbound=outbound,
            persistent=persistent
            or their_info.node_id in self.persistent_addrs,
            max_streams=self.host.rcmgr.max_streams_per_conn,
            stream_queue=self.host.rcmgr.stream_queue,
            send_rate=self.send_rate,
            recv_rate=self.recv_rate,
        )
        self._register_peer(peer)
        return peer

    async def _remove_peer(self, peer, exc, reconnect=False) -> None:
        present = self.peers.get(peer.peer_id) is peer
        await super()._remove_peer(peer, exc, reconnect)
        if present:
            self.host.conn_closed()

    def _evict_peer_sync(self, peer, reason) -> None:
        # duplicate-resolution loser: release its admission slot like
        # _remove_peer does, or incarnation churn leaks rcmgr capacity
        present = self.peers.get(peer.peer_id) is peer
        super()._evict_peer_sync(peer, reason)
        if present:
            self.host.conn_closed()

    def ban_peer(self, peer_id: str) -> None:
        self.host.gater.denied_peers.add(peer_id)
        super().ban_peer(peer_id)
