"""Peer: a connected remote node (reference p2p/peer.go:23).

Wraps the MConnection with identity/metadata and a small KV store that
reactors use to stash per-peer state (reference peer.Set/Get). A copy
of the JAX package's ``p2p/peer.py``, with the reference's channel
check (p2p/peer.go Send/TrySend, ``hasChannel``): a message goes out
only on a channel the remote advertised in its NodeInfo, so a node
never kills the connection of a peer that runs fewer reactors (the
JAX Peer sends on every local channel).
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, List, Optional

from .conn.connection import MConnection
from .conn.secret_connection import SecretConnection
from .node_info import NodeInfo


class Peer:
    def __init__(
        self,
        sconn: SecretConnection,
        node_info: NodeInfo,
        conn_str: str,
        channels: List[tuple],
        on_receive: Callable,  # (chan_id, msg_bytes, peer)
        on_error: Optional[Callable] = None,  # (peer, exc)
        outbound: bool = False,
        persistent: bool = False,
        mconn_config: Optional[dict] = None,
    ):
        self.node_info = node_info
        self.conn_str = conn_str
        self.outbound = outbound
        self.persistent = persistent
        self._data: Dict[str, Any] = {}
        # an empty list advertises nothing to check against: send all
        self._remote_channels = frozenset(node_info.channels)
        self.mconn = MConnection(
            sconn,
            channels,
            on_receive=lambda cid, msg: on_receive(cid, msg, self),
            on_error=(lambda e: on_error(self, e)) if on_error else None,
            **(mconn_config or {}),
        )

    # --- identity -----------------------------------------------------

    @property
    def peer_id(self) -> str:
        return self.node_info.node_id

    def __repr__(self) -> str:
        return f"Peer({self.peer_id[:10]}@{self.conn_str})"

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        self.mconn.start()

    async def stop(self) -> None:
        # bounded: mconn.stop is itself bounded, this is the
        # belt over its braces — a hung peer must never hang the switch
        try:
            await asyncio.wait_for(self.mconn.stop(), 7.0)
        except asyncio.TimeoutError:
            # graceful close ran out of budget mid-drain: the fd MUST
            # still die or the remote keeps a zombie peer entry that
            # dup-discards this node's next incarnation (the rejoin
            # wedge) — abort is sync and total
            self.mconn.abort()

    def abort(self) -> None:
        """Synchronous last-resort close (never awaits): see
        MConnection.abort."""
        self.mconn.abort()

    def inject_error(self, exc: Exception) -> None:
        """Chaos hook: die as if ``exc`` came from a conn routine
        (e.g. an injected pong timeout) — see MConnection.inject_error."""
        self.mconn.inject_error(exc)

    # --- messaging ----------------------------------------------------

    def has_channel(self, chan_id: int) -> bool:
        return not self._remote_channels or chan_id in self._remote_channels

    async def send(self, chan_id: int, msg: bytes) -> bool:
        if not self.has_channel(chan_id):
            return False
        return await self.mconn.send(chan_id, msg)

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        if not self.has_channel(chan_id):
            return False
        return self.mconn.try_send(chan_id, msg)

    # --- traffic totals (uniform across peer implementations) ---------

    @property
    def recv_total(self) -> int:
        return self.mconn.recv_flow.total

    @property
    def send_total(self) -> int:
        return self.mconn.send_flow.total

    # --- per-peer reactor state ---------------------------------------

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value
