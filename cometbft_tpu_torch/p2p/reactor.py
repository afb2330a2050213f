"""Reactor base class (reference p2p/base_reactor.go:15).

A copy of the JAX package's ``p2p/reactor.py``.

A reactor owns a set of channels and reacts to peer lifecycle +
messages. All callbacks run on the switch's event loop; reactors spawn
their own gossip tasks per peer as needed.
"""

from __future__ import annotations

from typing import List, Optional

from .node_info import ChannelDescriptor
from .peer import Peer


class Reactor:
    name = "reactor"

    def __init__(self):
        self.switch = None

    def get_channels(self) -> List[ChannelDescriptor]:
        return []

    def set_switch(self, switch) -> None:
        self.switch = switch

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    def add_peer(self, peer: Peer) -> None:
        """Peer connected & handshaken; spawn gossip tasks here."""

    def remove_peer(self, peer: Peer, reason: Optional[Exception]) -> None:
        """Peer disconnected; tear down per-peer state."""

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        """A complete message arrived on one of our channels."""
