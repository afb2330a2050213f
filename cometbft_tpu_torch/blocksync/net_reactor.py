"""Blocksync network reactor: channel 0x40 wire protocol around the
BlockPool/BlockSyncReactor verify loop (reference blocksync/reactor.go,
channel id :21).

Messages: StatusRequest/StatusResponse(base, height),
BlockRequest(height), BlockResponse(block, commit), NoBlockResponse.
Peers answering requests serve blocks straight from their store; the
local pool side is bridged through NetPeerClient, which satisfies the
pool's async request_block(height) interface by pairing requests with
responses arriving on the channel.

A copy of the JAX package's ``blocksync/net_reactor.py`` over the
port's ``BlockSyncReactor``, whose window verifies run on ``device``
(None is the GPU and raises without one; a node passes its own). With
a ``block_ingestor`` (adaptive sync) every verified block enters the
running consensus state machine through ``ingest_verified_block``.
"""

from __future__ import annotations

import asyncio
import struct
import traceback
from typing import Callable, Dict, Optional

from ..p2p.node_info import ChannelDescriptor
from ..p2p.reactor import Reactor
from ..utils import codec, proto
from ..utils.tasks import spawn
from .reactor import BlockSyncReactor

BLOCKSYNC_CHANNEL = 0x40

MSG_STATUS_REQUEST = 0x01
MSG_STATUS_RESPONSE = 0x02
MSG_BLOCK_REQUEST = 0x03
MSG_BLOCK_RESPONSE = 0x04
MSG_NO_BLOCK_RESPONSE = 0x05

STATUS_POLL_INTERVAL_S = 2.0


class NetPeerClient:
    """Adapts one remote peer to the pool's request_block interface."""

    def __init__(self, peer, switch=None):
        self.peer = peer
        self.switch = switch  # stamp_msg (the magic escape); may be None
        self.pending: Dict[int, asyncio.Future] = {}

    async def request_block(self, height: int):
        fut = asyncio.get_running_loop().create_future()
        self.pending[height] = fut
        try:
            msg = bytes([MSG_BLOCK_REQUEST]) + struct.pack(">q", height)
            if self.switch is not None:
                msg = self.switch.stamp_msg(
                    BLOCKSYNC_CHANNEL, msg, "bs.request", height=height,
                    peer=self.peer.peer_id,
                )
            await self.peer.send(BLOCKSYNC_CHANNEL, msg)
            return await fut
        finally:
            self.pending.pop(height, None)

    def deliver(self, height: int, block) -> None:
        fut = self.pending.get(height)
        if fut and not fut.done():
            fut.set_result(block)


class BlockSyncNetReactor(Reactor):
    name = "blocksync"

    def __init__(
        self,
        state,
        block_exec,
        block_store,
        on_caught_up: Optional[Callable] = None,
        block_ingestor=None,  # fork: adaptive sync
        active: bool = True,
        local_blocks_chain=None,
        device=None,
    ):
        super().__init__()
        self.block_store = block_store
        self.inner = BlockSyncReactor(
            state,
            block_exec,
            block_store,
            on_caught_up=self._caught_up,
            block_ingestor=block_ingestor,
            local_blocks_chain=local_blocks_chain,
            device=device,
        )
        self.on_caught_up = on_caught_up
        # active=False: full node already caught up, only SERVES blocks
        # (reference: blocksync reactor with blockSync=false)
        self.active = active
        self.clients: Dict[str, NetPeerClient] = {}
        self._status_task: Optional[asyncio.Task] = None
        self._started_pool = False

    def get_channels(self):
        return [
            ChannelDescriptor(BLOCKSYNC_CHANNEL, priority=5, max_msg_size=1 << 22)
        ]

    def _caught_up(self, state) -> None:
        self.active = False
        if self.on_caught_up:
            self.on_caught_up(state)

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        if self.active:
            await self.inner.start()
            self._started_pool = True
        self._status_task = asyncio.create_task(self._status_routine())

    async def activate(self, state) -> None:
        """Begin syncing from a statesync-bootstrapped state
        (reference statesync -> blocksync phase hand-off)."""
        self.inner.state = state
        self.inner.pool.start_height = state.last_block_height + 1
        self.inner.pool.height = state.last_block_height + 1
        self.active = True
        await self.inner.start()
        self._started_pool = True
        # re-announce + re-query statuses so the pool learns ranges
        if self.switch is not None:
            self.switch.broadcast(
                BLOCKSYNC_CHANNEL, bytes([MSG_STATUS_REQUEST])
            )

    async def stop(self) -> None:
        if self._status_task:
            self._status_task.cancel()
        if self._started_pool:
            # bounded: the pool routine can be parked in an executor
            # verify wait — don't let it wedge teardown
            try:
                await asyncio.wait_for(self.inner.stop(), 10.0)
            except asyncio.TimeoutError:
                pass

    async def _status_routine(self) -> None:
        try:
            while True:
                if self.active and self.switch is not None:
                    self.switch.broadcast(
                        BLOCKSYNC_CHANNEL,
                        bytes([MSG_STATUS_REQUEST]),
                        tkind="bs.status",
                    )
                await asyncio.sleep(STATUS_POLL_INTERVAL_S)
        except asyncio.CancelledError:
            raise

    # --- peers --------------------------------------------------------

    def add_peer(self, peer) -> None:
        self.clients[peer.peer_id] = NetPeerClient(peer, self.switch)
        # announce our status so the peer can request from us
        peer.try_send(BLOCKSYNC_CHANNEL, self._status_response())
        if self.active:
            peer.try_send(BLOCKSYNC_CHANNEL, bytes([MSG_STATUS_REQUEST]))

    def remove_peer(self, peer, reason) -> None:
        self.clients.pop(peer.peer_id, None)
        self.inner.pool.remove_peer(peer.peer_id)

    # --- wire ---------------------------------------------------------

    def _status_response(self) -> bytes:
        return bytes([MSG_STATUS_RESPONSE]) + struct.pack(
            ">qq", self.block_store.base(), self.block_store.height()
        )

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        mtype = msg[0]
        body = msg[1:]
        if mtype == MSG_STATUS_REQUEST:
            peer.try_send(BLOCKSYNC_CHANNEL, self._status_response())
        elif mtype == MSG_STATUS_RESPONSE:
            base, height = struct.unpack(">qq", body)
            cli = self.clients.get(peer.peer_id)
            if cli and self.active:
                self.inner.pool.set_peer_range(
                    peer.peer_id, cli, max(base, 1), height
                )
        elif mtype == MSG_BLOCK_REQUEST:
            (height,) = struct.unpack(">q", body)
            block = self.block_store.load_block(height)
            if block is None:
                peer.try_send(
                    BLOCKSYNC_CHANNEL,
                    bytes([MSG_NO_BLOCK_RESPONSE]) + struct.pack(">q", height),
                )
                return
            payload = proto.field_bytes(1, codec.encode_block(block))
            # vote extensions: ship the stored extended commit so the
            # syncing node can later propose with ExtendedCommitInfo
            # (reference blocksync BlockResponse.ExtCommit,
            # reactor.go:648)
            ec = self.block_store.load_extended_commit(height)
            if ec:
                payload += proto.field_bytes(2, ec)
            resp = bytes([MSG_BLOCK_RESPONSE]) + payload
            if self.switch is not None:
                resp = self.switch.stamp_msg(
                    BLOCKSYNC_CHANNEL, resp, "bs.block",
                    height=height, peer=peer.peer_id,
                )
            spawn(
                peer.send(BLOCKSYNC_CHANNEL, resp),
                name="blocksync-block-response",
            )
        elif mtype == MSG_BLOCK_RESPONSE:
            m = proto.parse(body)
            block = codec.decode_block(proto.get1(m, 1, b""))
            ec_bytes = proto.get1(m, 2, b"")
            if ec_bytes:
                # carried out-of-band to the verify/apply loop (the
                # pool's data path is block-shaped)
                block._ec_bytes = ec_bytes
            cli = self.clients.get(peer.peer_id)
            if cli:
                cli.deliver(block.height, block)
        elif mtype == MSG_NO_BLOCK_RESPONSE:
            (height,) = struct.unpack(">q", body)
            cli = self.clients.get(peer.peer_id)
            if cli:
                cli.deliver(height, None)
        else:
            raise ValueError(f"unknown blocksync msg type {mtype}")
