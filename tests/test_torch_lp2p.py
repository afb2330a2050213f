"""The port's lp2p stack (cometbft_tpu_torch.lp2p) against the JAX
package's, on the CPU.

- The ten cases of the JAX package's tests/test_lp2p.py, on the port:
  the stream muxer (open, send, receive, close; independent streams; the
  stream cap), the protocol-id mapping, the host's gater and resource
  manager, switch-level nets over per-channel streams (connect and
  broadcast on the default autopool, a ban feeding the gater, a dead
  peer's admission slot released) and four validator Nodes reaching
  consensus with the switcher picked by config.
- Bytes: the same operations, with payloads drawn from one numpy seed,
  give the same frames from both packages' muxers, and a port muxer and
  a JAX muxer share one secret connection (each over its own package's
  handshake), streams opened from either end.
- A mixed net: two port Nodes (``device="cpu"``) and two JAX Nodes, all
  on lp2p with PEX on (both defaults), store the same blocks to height
  4, as tests/test_torch_net_parity.py's mixed net does over TCP.
"""

import asyncio
import os
import socket

import numpy as np
import pytest
import torch

from cometbft_tpu.config.config import test_config as jtest_config
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.lp2p import mux as jmux
from cometbft_tpu.lp2p.switch import Lp2pSwitch as JLp2pSwitch
from cometbft_tpu.node.node import Node as JNode
from cometbft_tpu.p2p.conn.secret_connection import SecretConnection as JSecretConnection
from cometbft_tpu.privval.file_pv import FilePV as JFilePV
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.lp2p import (
    ConnGater,
    Host,
    Lp2pSwitch,
    Muxer,
    ResourceManager,
)
from cometbft_tpu_torch.lp2p import mux as pmux
from cometbft_tpu_torch.lp2p.switch import channel_protocol, protocol_channel
from cometbft_tpu_torch.p2p import (
    ChannelDescriptor,
    MemoryTransport,
    NodeInfo,
    NodeKey,
    Reactor,
    TCPTransport,
)
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
SEED = 12


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _sconn_pair(left=SecretConnection, right=SecretConnection):
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    r1, w1 = await asyncio.open_connection(sock=a)
    r2, w2 = await asyncio.open_connection(sock=b)
    k1, k2 = NodeKey.generate(), NodeKey.generate()
    j1, j2 = (JPriv.from_seed(k.priv_key.seed) if cls is JSecretConnection else k.priv_key
              for k, cls in ((k1, left), (k2, right)))
    return await asyncio.gather(left.handshake(r1, w1, j1), right.handshake(r2, w2, j2))


# --- muxer ------------------------------------------------------------


def test_mux_open_send_recv_close():
    async def main():
        c1, c2 = await _sconn_pair()
        accepted = []
        m1 = Muxer(c1, initiator=True, on_stream=accepted.append)
        m2 = Muxer(c2, initiator=False, on_stream=accepted.append)
        m1.start()
        m2.start()
        st = await m1.open_stream("/cometbft/ch/0x20")
        await st.send(b"proposal")
        await st.send(b"vote")
        for _ in range(100):
            if accepted:
                break
            await asyncio.sleep(0.01)
        (remote,) = accepted
        assert remote.protocol == "/cometbft/ch/0x20"
        assert await remote.recv() == b"proposal"
        assert await remote.recv() == b"vote"
        # large message spans many secret-connection chunks
        big = bytes(256) * 300  # 76800 bytes
        await st.send(big)
        assert await remote.recv() == big
        await st.close()
        assert await remote.recv() is None  # FIN observed
        await m1.stop()
        await m2.stop()

    run(main())


def test_mux_streams_are_independent():
    """A full stream's backlog must not block another stream."""

    async def main():
        c1, c2 = await _sconn_pair()
        accepted = []
        m1 = Muxer(c1, initiator=True, on_stream=accepted.append)
        m2 = Muxer(c2, initiator=False, on_stream=accepted.append)
        m1.start()
        m2.start()
        slow = await m1.open_stream("/cometbft/ch/0x40")
        fast = await m1.open_stream("/cometbft/ch/0x22")
        for i in range(50):
            await slow.send(b"blocksync-%d" % i)
        await fast.send(b"urgent-vote")
        for _ in range(200):
            if len(accepted) == 2:
                break
            await asyncio.sleep(0.01)
        by_proto = {s.protocol: s for s in accepted}
        got = await asyncio.wait_for(by_proto["/cometbft/ch/0x22"].recv(), 5)
        assert got == b"urgent-vote"
        await m1.stop()
        await m2.stop()

    run(main())


def test_mux_stream_limit_resets_excess():
    async def main():
        c1, c2 = await _sconn_pair()
        m1 = Muxer(c1, initiator=True, on_stream=lambda s: None)
        m2 = Muxer(c2, initiator=False, on_stream=lambda s: None, max_streams=2)
        m1.start()
        m2.start()
        for i in range(2):
            await m1.open_stream(f"/cometbft/ch/{i:#04x}")
        third = await m1.open_stream("/cometbft/ch/0x99")
        # receiver RSTs the stream over its cap
        assert await asyncio.wait_for(third.recv(), 5) is None
        assert third.reset
        await m1.stop()
        await m2.stop()

    run(main())


def test_protocol_mapping_roundtrip():
    for cid in (0x00, 0x20, 0x38, 0x61):
        assert protocol_channel(channel_protocol(cid)) == cid
    assert protocol_channel("/bogus/proto") is None


# --- host admission ---------------------------------------------------


def test_gater_denies_dial_and_secured():
    async def main():
        nk1, nk2 = NodeKey.generate(), NodeKey.generate()
        i1 = NodeInfo(node_id=nk1.node_id, network="lp2p-test")
        i2 = NodeInfo(node_id=nk2.node_id, network="lp2p-test")
        t1 = MemoryTransport(nk1, i1)
        t2 = MemoryTransport(nk2, i2)
        await t1.listen()
        await t2.listen()
        gater = ConnGater()
        gater.denied_peers.add(nk2.node_id)
        h1 = Host(t1, gater=gater)
        with pytest.raises(Exception):
            await h1.dial(f"mem://{nk2.node_id}", nk2.node_id)
        # denied at the secured stage even when the dial target was
        # not named up front
        with pytest.raises(Exception):
            await h1.dial(f"mem://{nk2.node_id}")
        assert h1.rcmgr.open_conns == 0
        await t1.close()
        await t2.close()

    run(main())


def test_resource_manager_conn_cap():
    async def main():
        nk1 = NodeKey.generate()
        i1 = NodeInfo(node_id=nk1.node_id, network="lp2p-test")
        t1 = MemoryTransport(nk1, i1)
        await t1.listen()
        h1 = Host(t1, rcmgr=ResourceManager(max_conns=0))
        nk2 = NodeKey.generate()
        i2 = NodeInfo(node_id=nk2.node_id, network="lp2p-test")
        t2 = MemoryTransport(nk2, i2)
        await t2.listen()
        with pytest.raises(Exception):
            await h1.dial(f"mem://{nk2.node_id}", nk2.node_id)
        await t1.close()
        await t2.close()

    run(main())


# --- switch-level -----------------------------------------------------


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


def _make_lp2p_switch(chain_id="lp2p-test", transport_cls=TCPTransport):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network=chain_id)
    tr = transport_cls(nk, info)
    sw = Lp2pSwitch(tr, info)
    er = sw.add_reactor("echo", EchoReactor())
    return sw, er


def test_lp2p_switch_connect_broadcast():
    async def main():
        sw1, er1 = _make_lp2p_switch()
        sw2, er2 = _make_lp2p_switch()
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
        for _ in range(100):
            sw1.broadcast(EchoReactor.CHAN, b"ping-all")
            if (sw1.node_info.node_id, b"ping-all") in er2.got:
                break
            await asyncio.sleep(0.05)
        assert (sw1.node_info.node_id, b"ping-all") in er2.got
        for _ in range(100):
            if (sw2.node_info.node_id, b"ack:ping-all") in er1.got:
                break
            await asyncio.sleep(0.05)
        assert (sw2.node_info.node_id, b"ack:ping-all") in er1.got
        # the class default drains reactor messages through the autopool
        assert sw2.autopool is not None and sw2.autopool.processed >= 1
        await sw1.stop()
        await sw2.stop()

    run(main())


def test_lp2p_ban_peer_feeds_gater():
    async def main():
        sw1, er1 = _make_lp2p_switch(transport_cls=MemoryTransport)
        sw2, _ = _make_lp2p_switch(transport_cls=MemoryTransport)
        await sw1.transport.listen()
        await sw2.transport.listen()
        await sw1.start()
        await sw2.start()
        await sw1.dial_peer(sw2.transport.listen_addr)
        for _ in range(100):
            if sw1.num_peers():
                break
            await asyncio.sleep(0.05)
        sw1.ban_peer(sw2.node_info.node_id)
        for _ in range(100):
            if not sw1.num_peers():
                break
            await asyncio.sleep(0.05)
        assert sw1.num_peers() == 0
        assert sw2.node_info.node_id in sw1.host.gater.denied_peers
        # redial by id is refused (banned set short-circuits); a dial
        # without a named id is stopped by the gater at secured stage
        got = await sw1.dial_peer(f"{sw2.node_info.node_id}@{sw2.transport.listen_addr}")
        assert got is None
        with pytest.raises(Exception):
            await sw1.host.dial(sw2.transport.listen_addr)
        assert sw1.num_peers() == 0
        await sw1.stop()
        await sw2.stop()

    run(main())


def test_lp2p_peer_drop_notifies_reactors():
    async def main():
        sw1, er1 = _make_lp2p_switch(transport_cls=MemoryTransport)
        sw2, er2 = _make_lp2p_switch(transport_cls=MemoryTransport)
        await sw1.transport.listen()
        await sw2.transport.listen()
        await sw1.start()
        await sw2.start()
        await sw1.dial_peer(sw2.transport.listen_addr)
        for _ in range(100):
            if sw1.num_peers() and sw2.num_peers():
                break
            await asyncio.sleep(0.05)
        # hard-stop sw2's peer object; sw1 must notice the dead conn
        peer2 = next(iter(sw2.peers.values()))
        await peer2.stop()
        for _ in range(200):
            if er1.removed:
                break
            sw1.broadcast(EchoReactor.CHAN, b"probe")
            await asyncio.sleep(0.05)
        assert er1.removed
        assert sw1.host.rcmgr.open_conns == 0
        await sw1.stop()
        await sw2.stop()

    run(main())


# --- full nodes over the lp2p switcher --------------------------------


def test_consensus_over_lp2p_net():
    """4 validators reach consensus with the alternative switcher
    selected by config (reference analog: lp2p-backed e2e nets)."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    gen, privs = make_genesis(4, chain_id="lp2p-chain")
    pvs = make_privvals(privs)

    async def main():
        nodes = []
        for i, pv_ in enumerate(pvs):
            cfg = make_test_cfg(".")
            cfg.p2p.laddr = "tcp://127.0.0.1:0"
            cfg.p2p.use_libp2p_equivalent = True
            cfg.base.moniker = f"lpnode{i}"
            cfg.blocksync.enable = False
            nodes.append(Node(cfg, gen, privval=pv_, device=CPU))
        for n in nodes:
            assert isinstance(n.switch, Lp2pSwitch)
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            for n in nodes:
                for _ in range(200):
                    if n.switch.num_peers() >= 3:
                        break
                    await asyncio.sleep(0.05)

            async def waiter():
                while not all(n.height >= 3 for n in nodes):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(waiter(), 90)
            h2 = {bytes(n.parts.block_store.load_block(2).hash()) for n in nodes}
            assert len(h2) == 1
        finally:
            for n in nodes:
                await n.stop()

    run(main(), timeout=150)


# --- bytes: the JAX muxer's frames --------------------------------------


class _Wire:
    """A secret connection that keeps what a muxer writes."""

    def __init__(self):
        self.frames = []

    async def write_msg(self, frame):
        self.frames.append(bytes(frame))

    async def read_chunk(self):
        await asyncio.Event().wait()

    def close(self):
        pass


def _ops():
    """Stream opens, messages of seeded sizes and contents, and closes."""
    rng = np.random.default_rng(SEED)
    ops = []
    for cid in (0x00, 0x20, 0x22, 0x30, 0x40, 0x61):
        ops.append(("open", channel_protocol(cid)))
    for _ in range(40):
        n = int(rng.integers(0, 3000))
        ops.append(("send", int(rng.integers(0, 6)), rng.bytes(n)))
    ops += [("close", 1), ("abort", 4), ("ping",)]
    return ops


async def _frames(mod, initiator):
    wire = _Wire()
    m = mod.Muxer(wire, initiator=initiator, on_stream=lambda s: None)
    m._tasks = [asyncio.create_task(m._send_routine())]
    streams = []
    for op in _ops():
        if op[0] == "open":
            streams.append(await m.open_stream(op[1]))
        elif op[0] == "send":
            await streams[op[1]].send(op[2])
        elif op[0] == "close":
            await streams[op[1]].close()
        elif op[0] == "abort":
            streams[op[1]].abort()
        else:
            m._handle(0, mod.PING, b"")  # answered with a PONG
    while not m._send_q.empty():
        await asyncio.sleep(0)
    await asyncio.sleep(0)
    await m.stop()
    return wire.frames


@pytest.mark.parametrize("initiator", [True, False], ids=["initiator", "accepter"])
def test_mux_frames_match_jax(initiator):
    async def main():
        port = await _frames(pmux, initiator)
        jax = await _frames(jmux, initiator)
        return port, jax

    port, jax = run(main())
    assert len(port) == 6 + 40 + 3 and port == jax
    sid, flag, n = pmux._HDR.unpack_from(port[0])
    assert (sid % 2, flag, port[0][pmux._HDR.size:]) == (int(initiator), pmux.SYN, b"/cometbft/ch/0x00")


@pytest.mark.parametrize("port_side", ["initiator", "accepter"])
def test_port_and_jax_muxers_share_a_connection(port_side):
    async def main():
        if port_side == "initiator":
            c1, c2 = await _sconn_pair(SecretConnection, JSecretConnection)
            mods = (pmux, jmux)
        else:
            c1, c2 = await _sconn_pair(JSecretConnection, SecretConnection)
            mods = (jmux, pmux)
        acc1, acc2 = [], []
        m1 = mods[0].Muxer(c1, initiator=True, on_stream=acc1.append)
        m2 = mods[1].Muxer(c2, initiator=False, on_stream=acc2.append)
        m1.start()
        m2.start()
        rng = np.random.default_rng(SEED)
        msgs = [rng.bytes(int(rng.integers(1, 40000))) for _ in range(8)]
        a = await m1.open_stream(channel_protocol(0x22))
        b = await m2.open_stream(channel_protocol(0x40))
        for msg in msgs:
            await a.send(msg)
            await b.send(msg[::-1])
        for _ in range(200):
            if acc1 and acc2:
                break
            await asyncio.sleep(0.01)
        (ra,), (rb,) = acc2, acc1
        assert (ra.protocol, rb.protocol) == (channel_protocol(0x22), channel_protocol(0x40))
        assert (ra.stream_id % 2, rb.stream_id % 2) == (1, 0)
        got_a = [await asyncio.wait_for(ra.recv(), 5) for _ in msgs]
        got_b = [await asyncio.wait_for(rb.recv(), 5) for _ in msgs]
        assert got_a == msgs and got_b == [m[::-1] for m in msgs]
        await a.close()
        assert await asyncio.wait_for(ra.recv(), 5) is None
        await m1.stop()
        await m2.stop()

    run(main())


# --- a mixed net over lp2p ---------------------------------------------


def _jax_privvals(privs, root):
    out = []
    for i, p in enumerate(privs):
        d = os.path.join(root, f"jpv{i}")
        os.makedirs(d)
        pv_ = JFilePV(JPriv.from_seed(p.seed), os.path.join(d, "key.json"), os.path.join(d, "state.json"))
        pv_.save_key()
        pv_.save_state()
        out.append(pv_)
    return out


async def _wait(cond, what, timeout=60):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        assert loop.time() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)


def test_mixed_lp2p_net_of_jax_and_port_nodes(tmp_path):
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    gen, privs = make_genesis(4, chain_id="mixed-lp2p", seed=SEED)
    jgen = JGenesisDoc.from_json(gen.to_json())
    ppvs = make_privvals(privs[:2], root=str(tmp_path))
    jpvs = _jax_privvals(privs[2:], str(tmp_path))

    def pcfg(i):
        c = make_test_cfg(".")
        c.base.moniker = f"port{i}"
        c.blocksync.enable = False
        c.p2p.use_libp2p_equivalent = True
        return c

    def jcfg(i):
        c = jtest_config(".")
        c.base.moniker = f"jax{i}"
        c.blocksync.enable = False
        c.p2p.laddr = "tcp://127.0.0.1:0"
        c.p2p.use_libp2p_equivalent = True
        c.rpc.laddr = ""
        return c

    async def main():
        nodes = [Node(pcfg(i), gen, privval=p, device=CPU) for i, p in enumerate(ppvs)]
        nodes += [JNode(jcfg(i), jgen, privval=p) for i, p in enumerate(jpvs)]
        assert all(isinstance(n.switch, Lp2pSwitch) for n in nodes[:2])
        assert all(isinstance(n.switch, JLp2pSwitch) for n in nodes[2:])
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await _wait(lambda: all(n.switch.num_peers() == 3 for n in nodes), "the full mesh")
            assert nodes[0].parts.mempool.check_tx(b"mixed=lp2p").is_ok()
            await _wait(lambda: all(n.height >= 4 for n in nodes), "height 4")

            def committed():
                return any(b"mixed=lp2p" in n.parts.block_store.load_block(h).data.txs
                           for n in nodes[2:] for h in range(1, n.height + 1))

            await _wait(committed, "the port node's tx in a JAX node's block")
            for h in range(1, 5):
                assert len({n.block_id_hash_at(h) for n in nodes}) == 1, h
            assert all(n.switch.num_peers() == 3 for n in nodes)
            assert all(n.parts.cs.loop_errors.count == 0 for n in nodes[:2])
        finally:
            for n in nodes:
                await n.stop()

    run(main(), timeout=150)
