"""Transports: TCP (production) and in-memory (tests).

Parity with reference p2p/transport.go:137-306 (MultiplexTransport):
accept/dial a raw stream, upgrade it with the secret-connection
handshake, verify the proven identity, then exchange NodeInfo. The
in-memory transport runs the EXACT same upgrade path over a
socketpair, so tests exercise the full encryption/auth stack without
touching the network (reference analog: p2p/test_util.go).

A copy of the JAX package's ``p2p/transport.py``. ``TCPTransport``
wraps each upgraded connection with ``p2p/fuzz.maybe_fuzz`` under its
``fuzz_config`` (the config's ``[fuzz]`` section; disabled or None is
a passthrough).
"""

from __future__ import annotations

import asyncio
import socket
import struct
from typing import Callable, Dict, Optional, Tuple

from ..utils.tasks import spawn
from .conn.secret_connection import SecretConnection
from .fuzz import maybe_fuzz
from .key import NodeKey, node_id_from_pubkey
from .node_info import NodeInfo

HANDSHAKE_TIMEOUT_S = 10.0


class TransportError(Exception):
    pass


async def _exchange_node_info(
    sconn: SecretConnection, our_info: NodeInfo
) -> NodeInfo:
    """Length-prefixed NodeInfo swap inside the encrypted channel."""
    enc = our_info.encode()
    await sconn.write_msg(struct.pack(">I", len(enc)) + enc)
    hdr = await sconn.read_chunk()
    (n,) = struct.unpack(">I", hdr[:4])
    if n > 1 << 20:
        raise TransportError("oversized node info")
    buf = hdr[4:]
    while len(buf) < n:
        buf += await sconn.read_chunk()
    return NodeInfo.decode(buf[:n])


async def upgrade(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    node_key: NodeKey,
    our_info: NodeInfo,
    expected_id: Optional[str] = None,
) -> Tuple[SecretConnection, NodeInfo]:
    """Secret-connection handshake + identity check + NodeInfo swap."""
    sconn = await SecretConnection.handshake(
        reader, writer, node_key.priv_key, timeout=HANDSHAKE_TIMEOUT_S
    )
    proven_id = node_id_from_pubkey(sconn.remote_pubkey)
    if expected_id is not None and proven_id != expected_id:
        sconn.close()
        raise TransportError(
            f"dialed {expected_id} but peer proved {proven_id}"
        )
    their_info = await asyncio.wait_for(
        _exchange_node_info(sconn, our_info), HANDSHAKE_TIMEOUT_S
    )
    if their_info.node_id != proven_id:
        sconn.close()
        raise TransportError("node info ID does not match proven identity")
    try:
        our_info.compatible_with(their_info)
    except ValueError as e:
        sconn.close()
        raise TransportError(str(e))
    return sconn, their_info


class TCPTransport:
    """listen() + accept stream; dial(). Produces upgraded
    (SecretConnection, NodeInfo, conn_str) triples."""

    def __init__(self, node_key: NodeKey, node_info: NodeInfo,
                 fuzz_config=None):
        self.node_key = node_key
        self.node_info = node_info
        self._server: Optional[asyncio.AbstractServer] = None
        self.accept_queue: asyncio.Queue = asyncio.Queue(64)
        # network fault injection (reference p2p/fuzz.go via config
        # FuzzConnConfig); None/disabled = passthrough
        self.fuzz_config = fuzz_config

    @property
    def listen_addr(self) -> str:
        if self._server is None or not self._server.sockets:
            return ""
        host, port = self._server.sockets[0].getsockname()[:2]
        return f"{host}:{port}"

    async def listen(self, addr: str) -> None:
        host, _, port = addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._on_accept, host or "0.0.0.0", int(port)
        )
        self.node_info.listen_addr = self.listen_addr

    async def _on_accept(self, reader, writer):
        peername = writer.get_extra_info("peername")
        try:
            sconn, their_info = await upgrade(
                reader, writer, self.node_key, self.node_info
            )
        except asyncio.CancelledError:
            writer.close()
            raise
        except Exception:
            try:
                writer.close()
            except Exception:
                pass
            return
        await self.accept_queue.put(
            (maybe_fuzz(sconn, self.fuzz_config), their_info, f"{peername[0]}:{peername[1]}")
        )

    async def accept(self):
        return await self.accept_queue.get()

    async def dial(
        self, addr: str, expected_id: Optional[str] = None
    ):
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        sconn, their_info = await upgrade(
            reader, writer, self.node_key, self.node_info, expected_id
        )
        return maybe_fuzz(sconn, self.fuzz_config), their_info, addr

    async def close(self) -> None:
        if self._server:
            self._server.close()
            # close conns nobody consumed, else (py3.12+) wait_closed
            # blocks until every accepted transport is closed
            while not self.accept_queue.empty():
                sconn, _, _ = self.accept_queue.get_nowait()
                sconn.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 1.0)
            except asyncio.TimeoutError:
                pass


class MemoryTransport:
    """In-process transport hub: dial by node ID, backed by OS
    socketpairs so the full secret-connection path runs.

    ``link_hook`` is the pluggable fault plane: an object with ``allow_dial(src_id, dst_id) ->
    bool`` consulted before a dial, and ``wrap(sconn, src_id, dst_id)
    -> conn`` applied to each side of an established connection so
    per-(src, dst) faults (partition, loss, latency, duplication,
    reordering) land on live links. ``None`` = passthrough."""

    _hubs: Dict[str, "MemoryTransport"] = {}

    def __init__(
        self,
        node_key: NodeKey,
        node_info: NodeInfo,
        network: str = "mem",
        link_hook=None,
    ):
        self.node_key = node_key
        self.node_info = node_info
        self.accept_queue: asyncio.Queue = asyncio.Queue(64)
        self._network = network
        self._addr = f"mem://{node_key.node_id}"
        self.link_hook = link_hook
        MemoryTransport._hubs[node_key.node_id] = self

    @property
    def listen_addr(self) -> str:
        return self._addr

    async def listen(self, addr: str = "") -> None:
        self.node_info.listen_addr = self._addr

    async def accept(self):
        return await self.accept_queue.get()

    async def dial(self, addr: str, expected_id: Optional[str] = None):
        target_id = addr.replace("mem://", "")
        our_id = self.node_key.node_id
        hub = MemoryTransport._hubs.get(target_id)
        if hub is None:
            raise TransportError(f"no in-memory node {target_id}")
        if self.link_hook is not None and not self.link_hook.allow_dial(
            our_id, target_id
        ):
            raise TransportError(
                f"link {our_id[:8]}->{target_id[:8]} partitioned"
            )
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        r1, w1 = await asyncio.open_connection(sock=a)
        r2, w2 = await asyncio.open_connection(sock=b)

        async def remote_side():
            try:
                sconn, info = await upgrade(
                    r2, w2, hub.node_key, hub.node_info
                )
                if hub.link_hook is not None:
                    # the hub's writes traverse the target->us link
                    sconn = hub.link_hook.wrap(sconn, target_id, our_id)
                await hub.accept_queue.put(
                    (sconn, info, f"mem://{our_id}")
                )
            except asyncio.CancelledError:
                w2.close()
                raise
            except Exception:
                try:
                    w2.close()
                except Exception:
                    pass

        task = spawn(remote_side(), name="mem-transport-accept")
        try:
            sconn, their_info = await upgrade(
                r1, w1, self.node_key, self.node_info, expected_id or target_id
            )
        except Exception:
            task.cancel()
            raise
        await task
        if self.link_hook is not None:
            sconn = self.link_hook.wrap(sconn, our_id, target_id)
        return sconn, their_info, addr

    async def close(self) -> None:
        MemoryTransport._hubs.pop(self.node_key.node_id, None)
        # drain conns nobody consumed: an in-process restart must not
        # inherit stale half-open connections from its previous life
        while not self.accept_queue.empty():
            sconn, _, _ = self.accept_queue.get_nowait()
            sconn.close()
