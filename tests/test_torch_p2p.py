"""The port's p2p stack: secret connection, MConnection multiplexing,
switch-level nets. The JAX package's tests/test_p2p.py, case for case,
on cometbft_tpu_torch.p2p (reference analog: p2p/conn/*_test.go,
p2p/switch_test.go via MakeConnectedSwitches)."""

import asyncio
import socket

import pytest

from cometbft_tpu_torch.p2p import (
    ChannelDescriptor,
    MemoryTransport,
    NodeInfo,
    NodeKey,
    Reactor,
    Switch,
    TCPTransport,
    node_id_from_pubkey,
)
from cometbft_tpu_torch.p2p.conn.connection import MConnection
from cometbft_tpu_torch.p2p.conn.secret_connection import (
    HandshakeError,
    SecretConnection,
)
from torch_hard_limit import hard_limit  # noqa: F401


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _pair():
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    r1, w1 = await asyncio.open_connection(sock=a)
    r2, w2 = await asyncio.open_connection(sock=b)
    return (r1, w1), (r2, w2)


async def _sconn_pair(k1=None, k2=None):
    k1 = k1 or NodeKey.generate()
    k2 = k2 or NodeKey.generate()
    (r1, w1), (r2, w2) = await _pair()
    c1, c2 = await asyncio.gather(
        SecretConnection.handshake(r1, w1, k1.priv_key),
        SecretConnection.handshake(r2, w2, k2.priv_key),
    )
    return c1, c2, k1, k2


def test_secret_connection_identity_and_roundtrip():
    async def main():
        c1, c2, k1, k2 = await _sconn_pair()
        # each side learns the other's REAL pubkey
        assert bytes(c1.remote_pubkey) == bytes(k2.priv_key.pub_key())
        assert bytes(c2.remote_pubkey) == bytes(k1.priv_key.pub_key())
        await c1.write_msg(b"hello")
        assert await c2.read_chunk() == b"hello"
        # large message spans frames
        big = bytes(range(256)) * 20  # 5120 bytes
        await c2.write_msg(big)
        got = b""
        while len(got) < len(big):
            got += await c1.read_chunk()
        assert got == big

    run(main())


def test_secret_connection_tamper_detected():
    async def main():
        c1, c2, _, _ = await _sconn_pair()
        sealed = c1._seal(b"payload")
        tampered = bytes([sealed[0] ^ 0xFF]) + sealed[1:]
        with pytest.raises(Exception):
            c2._open(tampered)

    run(main())


def test_mconnection_multiplex_and_reassembly():
    async def main():
        c1, c2, _, _ = await _sconn_pair()
        got = {}
        done = asyncio.Event()

        def on_recv(cid, msg):
            got.setdefault(cid, []).append(msg)
            if sum(len(v) for v in got.values()) == 3:
                done.set()

        m1 = MConnection(c1, [(0x20, 5), (0x30, 1)], on_receive=lambda c, m: None)
        m2 = MConnection(c2, [(0x20, 5), (0x30, 1)], on_receive=on_recv)
        m1.start()
        m2.start()
        big = b"x" * 5000  # multi-packet message
        await m1.send(0x20, b"vote")
        await m1.send(0x30, big)
        await m1.send(0x20, b"proposal")
        await asyncio.wait_for(done.wait(), 10)
        assert got[0x20] == [b"vote", b"proposal"]
        assert got[0x30] == [big]
        await m1.stop()
        await m2.stop()

    run(main())


def test_mconnection_ping_pong_keepalive():
    async def main():
        c1, c2, _, _ = await _sconn_pair()
        errs = []
        m1 = MConnection(
            c1, [(0, 1)], on_receive=lambda c, m: None,
            on_error=errs.append, ping_interval_s=0.05, pong_timeout_s=1.0,
        )
        m2 = MConnection(c2, [(0, 1)], on_receive=lambda c, m: None)
        m1.start()
        m2.start()
        await asyncio.sleep(0.4)  # several ping cycles must survive
        assert not errs
        await m1.stop()
        await m2.stop()

    run(main())


class EchoReactor(Reactor):
    name = "echo"
    CHAN = 0x77

    def __init__(self):
        super().__init__()
        self.got = []
        self.peers_seen = []
        self.removed = []

    def get_channels(self):
        return [ChannelDescriptor(self.CHAN, priority=3)]

    def add_peer(self, peer):
        self.peers_seen.append(peer.peer_id)

    def remove_peer(self, peer, reason):
        self.removed.append(peer.peer_id)

    def receive(self, chan_id, peer, msg):
        self.got.append((peer.peer_id, msg))
        if not msg.startswith(b"ack:"):
            peer.try_send(chan_id, b"ack:" + msg)


def _make_switch(chain_id="p2p-test", transport_cls=TCPTransport):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network=chain_id)
    tr = transport_cls(nk, info)
    sw = Switch(tr, info)
    er = sw.add_reactor("echo", EchoReactor())
    return sw, er


def test_switch_tcp_connect_broadcast():
    async def main():
        sw1, er1 = _make_switch()
        sw2, er2 = _make_switch()
        await sw1.transport.listen("127.0.0.1:0")
        await sw2.transport.listen("127.0.0.1:0")
        await sw1.start()
        await sw2.start()
        await sw1.dial_peer(sw2.transport.listen_addr)
        for _ in range(100):
            if sw2.num_peers() and sw1.num_peers():
                break
            await asyncio.sleep(0.05)
        assert sw1.num_peers() == 1 and sw2.num_peers() == 1
        assert er1.peers_seen and er2.peers_seen
        sw1.broadcast(EchoReactor.CHAN, b"ping-all")
        for _ in range(100):
            if er1.got:
                break
            await asyncio.sleep(0.05)
        # sw2 received and acked
        assert (sw1.node_info.node_id, b"ping-all") in er2.got
        assert (sw2.node_info.node_id, b"ack:ping-all") in er1.got
        await sw1.stop()
        await sw2.stop()

    run(main())


def test_switch_network_mismatch_rejected():
    async def main():
        sw1, _ = _make_switch(chain_id="chain-A")
        sw2, _ = _make_switch(chain_id="chain-B")
        await sw1.transport.listen("127.0.0.1:0")
        await sw2.transport.listen("127.0.0.1:0")
        await sw1.start()
        await sw2.start()
        with pytest.raises(Exception):
            await sw1.dial_peer(sw2.transport.listen_addr)
        assert sw1.num_peers() == 0
        await sw1.stop()
        await sw2.stop()

    run(main())


def test_switch_wrong_id_rejected():
    async def main():
        sw1, _ = _make_switch()
        sw2, _ = _make_switch()
        await sw1.transport.listen("127.0.0.1:0")
        await sw2.transport.listen("127.0.0.1:0")
        await sw1.start()
        await sw2.start()
        bogus_id = "00" * 20
        with pytest.raises(Exception):
            await sw1.dial_peer(
                f"{bogus_id}@{sw2.transport.listen_addr}"
            )
        assert sw1.num_peers() == 0
        await sw1.stop()
        await sw2.stop()

    run(main())


def test_switch_memory_transport_net():
    async def main():
        sws = [
            _make_switch(transport_cls=MemoryTransport) for _ in range(3)
        ]
        for sw, _ in sws:
            await sw.transport.listen()
            await sw.start()
        # fully connect
        for i, (sw, _) in enumerate(sws):
            for j, (other, _) in enumerate(sws):
                if j > i:
                    await sw.dial_peer(other.transport.listen_addr)
        assert all(sw.num_peers() == 2 for sw, _ in sws)
        sws[0][0].broadcast(EchoReactor.CHAN, b"hello-mem")
        for _ in range(100):
            if len(sws[0][1].got) >= 2:
                break
            await asyncio.sleep(0.05)
        acks = [m for _, m in sws[0][1].got if m == b"ack:hello-mem"]
        assert len(acks) == 2
        for sw, _ in sws:
            await sw.stop()

    run(main())


def test_peer_error_removes_and_notifies_reactors():
    async def main():
        sw1, er1 = _make_switch()
        sw2, er2 = _make_switch()
        await sw1.transport.listen("127.0.0.1:0")
        await sw2.transport.listen("127.0.0.1:0")
        await sw1.start()
        await sw2.start()
        peer = await sw1.dial_peer(sw2.transport.listen_addr)
        for _ in range(100):
            if sw2.num_peers():
                break
            await asyncio.sleep(0.05)
        sw1.stop_peer_for_error(peer, RuntimeError("test"))
        for _ in range(100):
            if er1.removed and sw1.num_peers() == 0:
                break
            await asyncio.sleep(0.05)
        assert er1.removed == [peer.peer_id]
        await sw1.stop()
        await sw2.stop()

    run(main())
