"""Statesync reactor: snapshot/chunk wire protocol on channels
0x60/0x61 (reference statesync/reactor.go:21-23) + the node-side sync
entrypoint that bootstraps the stores (reference node/setup.go:560
performStateSync).

A copy of the JAX package's ``statesync/reactor.py``, the same codec
byte for byte: snapshots and chunks are served off the event loop
(``asyncio.to_thread``), and a chunk being served pins its height
under the retention plane's serve floor. ``sync`` takes the config's
``chunk_request_timeout_s`` (the JAX reactor leaves the syncer's 10 s
default)."""

from __future__ import annotations

import asyncio
import struct
from typing import Dict, Optional

from ..abci import types as abci
from ..p2p.node_info import ChannelDescriptor
from ..p2p.reactor import Reactor
from ..utils import proto
from ..utils.tasks import spawn
from .syncer import CHUNK_TIMEOUT_S, Syncer

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

MSG_SNAPSHOTS_REQUEST = 0x01
MSG_SNAPSHOTS_RESPONSE = 0x02
MSG_CHUNK_REQUEST = 0x03
MSG_CHUNK_RESPONSE = 0x04

MAX_ADVERTISED_SNAPSHOTS = 10


def _encode_snapshot(s: abci.Snapshot) -> bytes:
    return (
        proto.field_varint(1, s.height)
        + proto.field_varint(2, s.format)
        + proto.field_varint(3, s.chunks)
        + proto.field_bytes(4, s.hash)
        + proto.field_bytes(5, s.metadata)
    )


def _decode_snapshot(b: bytes) -> abci.Snapshot:
    m = proto.parse(b)
    return abci.Snapshot(
        height=proto.get1(m, 1, 0),
        format=proto.get1(m, 2, 0),
        chunks=proto.get1(m, 3, 0),
        hash=proto.get1(m, 4, b""),
        metadata=proto.get1(m, 5, b""),
    )


class StateSyncReactor(Reactor):
    name = "statesync"

    def __init__(self, proxy, enabled: bool = False):
        super().__init__()
        self.proxy = proxy  # AppConns (serves snapshots to peers)
        self.enabled = enabled
        self.syncer: Optional[Syncer] = None
        # pending chunk requests: (peer, height, format, index) -> fut
        self._pending: Dict[tuple, asyncio.Future] = {}
        # retention plane handle (store/retention.py): while a chunk
        # for height H streams to a joiner, H is pinned against
        # pruning (the in-flight-serve floor); None = no plane
        self.retention = None

    def get_channels(self):
        return [
            ChannelDescriptor(SNAPSHOT_CHANNEL, priority=5, max_msg_size=1 << 20),
            ChannelDescriptor(CHUNK_CHANNEL, priority=3, max_msg_size=1 << 22),
        ]

    # --- node-side sync entrypoint --------------------------------------

    async def sync(
        self,
        state_provider,
        state_store,
        block_store,
        discovery_time_s: float = 5.0,
        chunk_timeout_s: float = CHUNK_TIMEOUT_S,
    ):
        """Discover + restore a snapshot, bootstrap the stores, return
        the new State (reference syncer.SyncAny + node bootstrap)."""
        self.syncer = Syncer(
            self.proxy,
            state_provider,
            request_chunk=self._request_chunk,
            discovery_time_s=discovery_time_s,
            chunk_timeout_s=chunk_timeout_s,
            # the syncer re-broadcasts while its pool is empty (a
            # rejected/timed-out snapshot must not idle out the whole
            # discovery window when peers hold newer snapshots)
            request_snapshots=self._broadcast_request,
        )
        # ask everyone we know for their snapshots
        self._broadcast_request()
        try:
            state, commit = await self.syncer.sync_any()
        finally:
            # resolve every in-flight chunk wait on the way out
            # (success, failure or CANCELLATION): an abandoned
            # `await fut` in _request_chunk would otherwise hold its
            # fetcher task alive forever — the leaked-task wedge a
            # cancelled chaos scenario exposed in asyncio.run cleanup
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_result(None)
        state_store.bootstrap(state)
        block_store.save_seen_commit(state.last_block_height, commit)
        return state

    def _broadcast_request(self) -> None:
        self.switch.broadcast(
            SNAPSHOT_CHANNEL, bytes([MSG_SNAPSHOTS_REQUEST])
        )

    async def _request_chunk(self, peer_id, height, format_, index):
        peer = self.switch.peers.get(peer_id)
        if peer is None:
            return None
        key = (peer_id, height, format_, index)
        fut = asyncio.get_running_loop().create_future()
        self._pending[key] = fut
        try:
            await peer.send(
                CHUNK_CHANNEL,
                bytes([MSG_CHUNK_REQUEST])
                + struct.pack(">qii", height, format_, index),
            )
            return await fut
        finally:
            self._pending.pop(key, None)

    # --- peers ----------------------------------------------------------

    def add_peer(self, peer) -> None:
        if self.enabled and self.syncer is not None:
            peer.try_send(SNAPSHOT_CHANNEL, bytes([MSG_SNAPSHOTS_REQUEST]))

    def remove_peer(self, peer, reason) -> None:
        if self.syncer is not None:
            self.syncer.pool.remove_peer(peer.peer_id)

    # --- wire -----------------------------------------------------------

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        mtype = msg[0]
        body = msg[1:]
        if mtype == MSG_SNAPSHOTS_REQUEST:
            # serving hits the app's snapshot store (disk): off-loop
            # (receive must never run an ABCI call)
            spawn(
                self._serve_snapshots(peer),
                name="statesync-serve-snapshots",
            )
        elif mtype == MSG_SNAPSHOTS_RESPONSE:
            if self.syncer is not None:
                self.syncer.pool.add(peer.peer_id, _decode_snapshot(body))
        elif mtype == MSG_CHUNK_REQUEST:
            height, format_, index = struct.unpack(">qii", body)
            spawn(
                self._serve_chunk(peer, height, format_, index),
                name="statesync-serve-chunk",
            )
        elif mtype == MSG_CHUNK_RESPONSE:
            height, format_, index, ok = struct.unpack(">qii?", body[:17])
            chunk = body[17:] if ok else None
            fut = self._pending.get((peer.peer_id, height, format_, index))
            if fut is not None and not fut.done():
                fut.set_result(chunk)
        else:
            raise ValueError(f"unknown statesync msg type {mtype}")

    async def _serve_snapshots(self, peer) -> None:
        snaps = await asyncio.to_thread(
            self.proxy.snapshot.list_snapshots
        )
        for snap in (snaps or [])[-MAX_ADVERTISED_SNAPSHOTS:]:
            peer.try_send(
                SNAPSHOT_CHANNEL,
                bytes([MSG_SNAPSHOTS_RESPONSE]) + _encode_snapshot(snap),
            )

    async def _serve_chunk(
        self, peer, height: int, format_: int, index: int
    ) -> None:
        def _load() -> Optional[bytes]:
            ret = self.retention
            if ret is not None:
                # pin the height for the duration of the load: the
                # retention plane must not prune a snapshot a joiner
                # is mid-download on (store/retention.py serve floor)
                with ret.serving(height):
                    return self.proxy.snapshot.load_snapshot_chunk(
                        height, format_, index
                    )
            return self.proxy.snapshot.load_snapshot_chunk(
                height, format_, index
            )

        chunk = await asyncio.to_thread(_load)
        peer.try_send(
            CHUNK_CHANNEL,
            bytes([MSG_CHUNK_RESPONSE])
            + struct.pack(">qii?", height, format_, index, bool(chunk))
            + (chunk or b""),
        )
