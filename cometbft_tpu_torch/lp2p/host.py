"""Host: connection admission for the lp2p stack.

Mirrors the reference's `lp2p/host.go:54-301` responsibilities the TPU
way: a **ResourceManager** caps connections / streams / queued bytes
(go-libp2p's rcmgr), and a **ConnGater** lets the switch veto peers at
dial time, at accept time, and after the handshake proves an identity
(reference `lp2p/host.go:263-301` InterceptPeerDial /
InterceptAccept / InterceptSecured). Transport setup (TCP or
in-memory socketpair) and the secret-connection handshake are shared
with the native stack — the stacks differ above the encrypted
connection, not below it. A copy of the JAX package's ``lp2p/host.py``.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional


class ResourceError(Exception):
    pass


class ResourceManager:
    """Static limits; count what is open, refuse past the cap."""

    def __init__(
        self,
        max_conns: int = 128,
        max_streams_per_conn: int = 64,
        stream_queue: int = 256,
    ):
        self.max_conns = max_conns
        self.max_streams_per_conn = max_streams_per_conn
        self.stream_queue = stream_queue
        self.open_conns = 0

    def acquire_conn(self) -> None:
        if self.open_conns >= self.max_conns:
            raise ResourceError(
                f"connection limit reached ({self.max_conns})"
            )
        self.open_conns += 1

    def release_conn(self) -> None:
        self.open_conns = max(0, self.open_conns - 1)


class ConnGater:
    """Pluggable admission callbacks; default allows everything.

    deny lists may be mutated at runtime (ban_peer feeds them)."""

    def __init__(
        self,
        intercept_peer_dial: Optional[Callable[[str], bool]] = None,
        intercept_accept: Optional[Callable[[str], bool]] = None,
        intercept_secured: Optional[Callable[[str], bool]] = None,
    ):
        self.denied_peers: set = set()
        self._dial = intercept_peer_dial
        self._accept = intercept_accept
        self._secured = intercept_secured

    def allow_peer_dial(self, peer_id: Optional[str]) -> bool:
        if peer_id and peer_id in self.denied_peers:
            return False
        return self._dial(peer_id) if (self._dial and peer_id) else True

    def allow_accept(self, conn_str: str) -> bool:
        return self._accept(conn_str) if self._accept else True

    def allow_secured(self, peer_id: str) -> bool:
        if peer_id in self.denied_peers:
            return False
        return self._secured(peer_id) if self._secured else True


class Host:
    """Bundles transport + admission; produces gated, resource-counted
    upgraded connections for the lp2p switch."""

    def __init__(
        self,
        transport,
        rcmgr: Optional[ResourceManager] = None,
        gater: Optional[ConnGater] = None,
    ):
        self.transport = transport
        self.rcmgr = rcmgr or ResourceManager()
        self.gater = gater or ConnGater()

    @property
    def listen_addr(self) -> str:
        return self.transport.listen_addr

    async def listen(self, addr: str = "") -> None:
        await self.transport.listen(addr)

    async def accept(self):
        """Next admitted inbound (sconn, node_info, conn_str)."""
        while True:
            sconn, their_info, conn_str = await self.transport.accept()
            if not self.gater.allow_accept(conn_str):
                sconn.close()
                continue
            if not self.gater.allow_secured(their_info.node_id):
                sconn.close()
                continue
            try:
                self.rcmgr.acquire_conn()
            except ResourceError:
                sconn.close()
                continue
            return sconn, their_info, conn_str

    async def dial(self, addr: str, expected_id: Optional[str] = None):
        if not self.gater.allow_peer_dial(expected_id):
            raise ResourceError(f"gater denied dial to {expected_id}")
        self.rcmgr.acquire_conn()
        try:
            sconn, their_info, conn_str = await self.transport.dial(
                addr, expected_id
            )
        except Exception:
            self.rcmgr.release_conn()
            raise
        if not self.gater.allow_secured(their_info.node_id):
            sconn.close()
            self.rcmgr.release_conn()
            raise ResourceError(
                f"gater denied secured peer {their_info.node_id}"
            )
        return sconn, their_info, conn_str

    def conn_closed(self) -> None:
        self.rcmgr.release_conn()

    async def close(self) -> None:
        # bounded: a wedged transport must not hang host close
        try:
            await asyncio.wait_for(self.transport.close(), 5.0)
        except asyncio.TimeoutError:
            pass
