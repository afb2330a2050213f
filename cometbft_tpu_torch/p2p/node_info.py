"""NodeInfo: what peers advertise during the post-encryption handshake
(reference p2p/node_info.go + node/node.go:1022-1071 makeNodeInfo).

A copy of the JAX package's ``p2p/node_info.py``; the JSON encoding is
the same, key for key.

Compatibility rules mirror the reference: same network (chain id),
at least one common channel, and — for outbound dials — the proven
identity (pubkey from the secret connection) must match the dialed ID.
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass, field
from typing import List


@dataclass
class ChannelDescriptor:
    chan_id: int
    priority: int = 1
    max_msg_size: int = 10 * 1024 * 1024


def _new_incarnation() -> str:
    """Per-process handshake nonce: one draw per constructed NodeInfo,
    so every incarnation of a node (each restart builds a fresh
    NodeInfo) advertises a distinct value. The switch's duplicate-conn
    resolution keys on (node id, incarnation) — a restarted remote's
    fresh dial must never be dup-discarded against its previous life's
    zombie entry."""
    return secrets.token_hex(8)


@dataclass
class NodeInfo:
    node_id: str
    network: str  # chain id
    listen_addr: str = ""
    version: str = "0.1.0"
    channels: List[int] = field(default_factory=list)
    moniker: str = ""
    rpc_address: str = ""
    # incarnation-safe dialing (p2p/switch.py _new_conn_wins); ""
    # on DECODED info from a peer that predates the field
    incarnation: str = field(default_factory=_new_incarnation)

    def encode(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "network": self.network,
                "listen_addr": self.listen_addr,
                "version": self.version,
                "channels": self.channels,
                "moniker": self.moniker,
                "rpc_address": self.rpc_address,
                "incarnation": self.incarnation,
            }
        ).encode()

    @classmethod
    def decode(cls, b: bytes) -> "NodeInfo":
        d = json.loads(b.decode())
        return cls(
            node_id=d["node_id"],
            network=d["network"],
            listen_addr=d.get("listen_addr", ""),
            version=d.get("version", ""),
            channels=list(d.get("channels", [])),
            moniker=d.get("moniker", ""),
            rpc_address=d.get("rpc_address", ""),
            incarnation=d.get("incarnation", ""),
        )

    def compatible_with(self, other: "NodeInfo") -> None:
        if other.network != self.network:
            raise ValueError(
                f"peer is on network {other.network!r}, not {self.network!r}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise ValueError("no common channels with peer")
