"""Mempool reactor: tx gossip on channel 0x30 (reference
mempool/reactor.go, channel id at mempool/mempool.go:13).

Per-peer broadcast routine mirrors the reference's clist-waiter loop
(mempool/reactor.go:217 broadcastTxRoutine): walk the mempool's tx
list in insertion order, skip txs the peer itself sent us (sender
tracking), and push everything else — coalesced into batch frames
(mempool/codec.py) up to ``gossip_batch_bytes`` per message. Inbound
txs decode and land on the micro-batching ingest queue
(mempool/ingest.py), so ``receive`` never blocks the event loop on an
ABCI call; the full CheckTx path still gates propagation, so invalid
txs never re-gossip.

A copy of the JAX package's ``mempool/reactor.py``: ``MempoolReactor``
and ``AppMempoolReactor`` (the app-side mempool's flood with dedup,
InsertTx off the loop). Outbound messages go out unstamped
(``Switch.stamp_msg``).
"""

from __future__ import annotations

import asyncio
import traceback
from collections import OrderedDict
from typing import Dict, List

from ..p2p import tracewire
from ..p2p.node_info import ChannelDescriptor
from ..p2p.reactor import Reactor
from . import codec
from ..utils.tasks import spawn
from .ingest import IngestQueue
from .mempool import tx_key

MEMPOOL_CHANNEL = 0x30
GOSSIP_INTERVAL_S = 0.05
# txs the legacy fallback path remembers per peer (no txs_after
# cursor): bounded so a long-lived peer can't grow the set forever
SENT_CACHE_SIZE = 65536
# hard frame cap = the channel descriptor's max_msg_size: a frame
# that crosses it kills the whole peer connection on the receiver
MAX_FRAME_BYTES = 1 << 20


def _frame_overhead(n_txs: int) -> int:
    """Worst-case batch framing bytes: magic + count varint + one
    length varint per tx (5 bytes covers lengths up to 2^35)."""
    return len(codec.MAGIC) + 5 + 5 * n_txs


class MempoolReactor(Reactor):
    name = "mempool"

    def __init__(
        self,
        mempool,
        broadcast: bool = True,
        batch_max_txs: int = 256,
        batch_flush_ms: float = 2.0,
        gossip_batch_bytes: int = 64 * 1024,
    ):
        super().__init__()
        self.mempool = mempool
        self.broadcast = broadcast  # config.Mempool.Broadcast
        self.gossip_batch_bytes = max(1, gossip_batch_bytes)
        self.batch_max_txs = max(1, batch_max_txs)
        self.ingest = IngestQueue(
            mempool,
            batch_max_txs=batch_max_txs,
            batch_flush_ms=batch_flush_ms,
        )
        self._tasks: Dict[str, asyncio.Task] = {}

    def get_channels(self):
        return [
            ChannelDescriptor(MEMPOOL_CHANNEL, priority=5, max_msg_size=1 << 20)
        ]

    async def start(self) -> None:
        self.ingest.start()

    def add_peer(self, peer) -> None:
        if self.broadcast:
            self._tasks[peer.peer_id] = asyncio.create_task(
                self._broadcast_tx_routine(peer)
            )

    def remove_peer(self, peer, reason) -> None:
        t = self._tasks.pop(peer.peer_id, None)
        if t:
            t.cancel()

    async def stop(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
        # bounded: ingest.stop is internally bounded; belt over
        # braces so a hung drain can't wedge the switch stop
        try:
            await asyncio.wait_for(self.ingest.stop(), 10.0)
        except asyncio.TimeoutError:
            pass

    async def _send_txs(self, peer, txs: List[bytes]) -> None:
        msg = codec.encode_txs(txs)
        if len(txs) == 1 and len(msg) > MAX_FRAME_BYTES:
            # a tx so large that the batch-of-one framing crosses the
            # channel cap: send the pre-batching wire form (raw tx,
            # <= max_tx_bytes <= channel cap); the receiver's decode
            # falls back to single-tx on the inevitable parse failure.
            # encode_plain still escapes a stamp-magic-prefixed tx so
            # the receiver's always-on peel cannot mutate it (raw only
            # when even the 3-byte escape would cross the cap)
            msg = tracewire.encode_plain(txs[0], MAX_FRAME_BYTES)
        elif self.switch is not None:
            # stamp_msg escapes a stamp-magic-prefixed frame (the JAX
            # switch stamps gossip batches here, outside the tx
            # framing)
            msg = self.switch.stamp_msg(
                MEMPOOL_CHANNEL, msg, "txs", peer=peer.peer_id
            )
        await peer.send(MEMPOOL_CHANNEL, msg)

    async def _broadcast_tx_routine(self, peer) -> None:
        cursor = 0
        use_cursor = hasattr(self.mempool, "txs_after")
        # fallback path only: bounded LRU of tx keys already pushed
        sent: "OrderedDict[bytes, None]" = OrderedDict()
        try:
            while True:
                pending: List[bytes] = []
                pending_bytes = 0

                async def flush():
                    nonlocal pending, pending_bytes
                    if pending:
                        await self._send_txs(peer, pending)
                        pending, pending_bytes = [], 0

                async def push(tx):
                    nonlocal pending_bytes
                    # flush BEFORE appending when this tx would push
                    # the frame past the channel cap (gossip_batch_
                    # bytes is a soft target; MAX_FRAME_BYTES kills
                    # the peer connection if crossed)
                    if pending and (
                        pending_bytes
                        + len(tx)
                        + _frame_overhead(len(pending) + 1)
                        > MAX_FRAME_BYTES
                    ):
                        await flush()
                    pending.append(tx)
                    pending_bytes += len(tx)
                    if (
                        pending_bytes >= self.gossip_batch_bytes
                        or len(pending) >= self.batch_max_txs
                    ):
                        await flush()

                if use_cursor:
                    # seq-cursor over the insertion log: O(new txs) per
                    # tick, no rescans, no re-flood
                    for seq, tx, senders in self.mempool.txs_after(cursor):
                        cursor = max(cursor, seq)
                        if peer.peer_id in senders:
                            continue  # peer gave it to us; don't echo
                        await push(tx)
                else:
                    for tx in self.mempool.iter_txs():
                        k = tx_key(tx)
                        if k in sent:
                            sent.move_to_end(k)
                            continue
                        sent[k] = None
                        while len(sent) > SENT_CACHE_SIZE:
                            sent.popitem(last=False)
                        await push(tx)
                await flush()
                await asyncio.sleep(GOSSIP_INTERVAL_S)
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        try:
            txs = codec.decode_txs(msg)
        except Exception:
            return  # malformed frame: drop, not fatal to the peer
        if self.ingest.running:
            for tx in txs:
                # a full queue drops the tx (counted): gossip is
                # best-effort, and shedding beats an unbounded queue
                self.ingest.submit_nowait(tx, sender=peer.peer_id)
        else:
            # ingest plane not started (reactor used standalone in
            # tests / unwired embedders): degrade to the direct path
            for tx in txs:
                self._check_tx_direct(tx, peer.peer_id)

    def _check_tx_direct(self, tx: bytes, sender: str) -> None:
        """Legacy direct CheckTx (blocks the caller); only the
        degraded path above uses it — live nodes go through the
        ingest queue so ``receive`` stays non-blocking."""
        try:
            self.mempool.check_tx(tx, sender=sender)
        except Exception:
            pass  # invalid txs are dropped, not fatal to the peer


class AppMempoolReactor(Reactor):
    """Fork feature: gossip for the app-side mempool (reference
    mempool/app_reactor.go). The app owns tx storage, so there is no
    pool to walk — relaying is flood-with-dedup: a tx accepted by
    InsertTx (guard-deduplicated) is forwarded to every OTHER peer
    exactly once."""

    name = "mempool"

    def __init__(self, mempool, broadcast: bool = True):
        super().__init__()
        self.mempool = mempool  # AppMempool
        self.broadcast = broadcast

    def get_channels(self):
        return [
            ChannelDescriptor(MEMPOOL_CHANNEL, priority=5, max_msg_size=1 << 20)
        ]

    def submit_local(self, tx: bytes):
        """Entry for locally-submitted txs (RPC broadcast_tx path)."""
        res = self.mempool.check_tx(tx)
        if res.is_ok() and self.broadcast and self.switch is not None:
            self.switch.broadcast(MEMPOOL_CHANNEL, tx, tkind="txs")
        return res

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        # InsertTx is a sync ABCI call: run it off-loop, forward on ok
        # (guard stops loops) — receive itself never blocks
        spawn(
            self._receive_async(peer.peer_id, msg),
            name="app-mempool-receive",
        )

    async def _receive_async(self, sender: str, msg: bytes) -> None:
        try:
            res = await asyncio.to_thread(
                self.mempool.check_tx, msg, sender
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            return
        if res.is_ok() and self.broadcast and self.switch is not None:
            # forward to everyone but the sender (guard stops loops);
            # encode once — stamp_msg escapes a magic-prefixed raw tx
            # (attacker-shaped bytes) so receivers never mutate it
            wire = self.switch.stamp_msg(MEMPOOL_CHANNEL, msg, "txs")
            for p in self.switch.peers.values():
                if p.peer_id != sender:
                    p.try_send(MEMPOOL_CHANNEL, wire)
