"""The port's cross-node trace-context stamping (p2p/tracewire.py and the
switch's stamping plane) held to the JAX package's: every case of
``tests/test_tracewire.py`` on cometbft_tpu_torch, and two more.

1. Wire codec: stamp/unstamp round trip, the zero-header escape,
   lossless fallback on anything unparseable.
2. ``TraceStamper``: send/recv instants, the channel-cap skip, the
   clock-domain gate on live propagation spans.
3. Switch interop over ``MemoryTransport``: stamping node <-> plain
   node, payloads byte-identical both ways.
4. Parity: the port's stamp is byte-equal to the JAX ``stamp`` for the
   same inputs and a fixed clock domain (each decodes the other's), and
   a mixed TCP net of a port ``Node`` and a JAX ``Node`` records each
   other's stamped arrivals, with both packages' ``attribute_heights``
   giving every committed height a complete chain over the two rings.
"""

import asyncio
import os

import numpy as np
import torch

from cometbft_tpu import trace as jtrace
from cometbft_tpu.p2p import tracewire as jtracewire
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.p2p import ChannelDescriptor, MemoryTransport, NodeInfo, NodeKey, Reactor, Switch
from cometbft_tpu_torch.p2p import tracewire
from cometbft_tpu_torch.trace import Tracer, attribute_heights, rebase
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- 1. wire codec -------------------------------------------------------


def test_stamp_unstamp_roundtrip_all_kinds():
    payload = b"\x01proposal-bytes" * 3
    for kind in tracewire.KINDS:
        wire = tracewire.stamp(payload, kind, seq=7, origin="n0", height=12, round_=2, send_ns=123456789)
        assert wire.startswith(tracewire.MAGIC)
        ctx, out = tracewire.unstamp(wire)
        assert out == payload
        assert ctx is not None
        assert ctx.kind == kind and ctx.seq == 7
        assert ctx.height == 12 and ctx.round == 2
        assert ctx.origin == "n0" and ctx.send_ns == 123456789
        assert ctx.clock == tracewire.CLOCK_DOMAIN


def test_stamp_roundtrip_edge_values():
    # no-round messages (blocksync) encode round -1 losslessly; empty
    # payloads and long origins survive (origin truncated to the cap)
    ctx, out = tracewire.unstamp(tracewire.stamp(b"", "bs.status", seq=0, origin="x" * 64))
    assert out == b"" and ctx.round == -1 and ctx.height == 0
    assert ctx.origin == "x" * tracewire._MAX_ORIGIN_LEN


def test_unstamped_passthrough_and_escape():
    raw = b"ordinary reactor message"
    assert tracewire.unstamp(raw) == (None, raw)
    assert tracewire.encode_plain(raw) == raw
    # a payload that happens to BEGIN with the magic is escaped by a
    # stamping-disabled sender so the receiver cannot misparse it
    tricky = tracewire.MAGIC + b"not actually a stamp"
    wire = tracewire.encode_plain(tricky)
    assert wire != tricky
    ctx, out = tracewire.unstamp(wire)
    assert ctx is None and out == tricky


def test_unparseable_after_magic_falls_back_to_raw():
    # a peer relaying raw bytes that start with the magic but do not
    # parse must come back unchanged (lossless both directions)
    for tail in (
        b"",  # bare magic
        b"\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff",  # overlong varint
        b"\x7f",  # header length way past the buffer
        b"\x03\x63\x00\x00",  # unknown kind id (99)
    ):
        msg = tracewire.MAGIC + tail
        ctx, out = tracewire.unstamp(msg)
        assert ctx is None and out == msg

    # truncated header: cut a valid stamp mid-header
    wire = tracewire.stamp(b"payload", "vote", 1, "n1", height=3)
    cut = wire[: len(tracewire.MAGIC) + 3]
    assert tracewire.unstamp(cut) == (None, cut)

    # origin length overrunning the declared header is rejected
    hdr = bytearray()
    for v in (0, 0, 0, 1, 0, 0, 40):  # kind seq send_ns clock height round+1, origin len LIE
        tracewire._put_uvarint(hdr, v)
    bad = bytearray(tracewire.MAGIC)
    tracewire._put_uvarint(bad, len(hdr))
    bad += hdr
    bad = bytes(bad)
    assert tracewire.unstamp(bad) == (None, bad)


# --- 2. TraceStamper -----------------------------------------------------


def test_stamper_records_correlated_send_recv_and_propagation():
    t_send = Tracer("sender", size=64)
    t_recv = Tracer("receiver", size=64)
    sender = tracewire.TraceStamper(t_send, origin="n0")
    receiver = tracewire.TraceStamper(t_recv, origin="n1")

    wire = sender.wrap(b"vote-bytes", "vote", height=5, round_=1, peer="abcdef", npeers=3)
    ctx, payload = tracewire.unstamp(wire)
    assert payload == b"vote-bytes"
    receiver.on_receive(ctx, "sender-peer-id")

    send_ev = [e for e in t_send.snapshot() if e["name"] == "p2p.msg.send"]
    assert len(send_ev) == 1
    assert send_ev[0]["args"]["kind"] == "vote"
    assert send_ev[0]["args"]["h"] == 5 and send_ev[0]["args"]["seq"] == 0
    # the ring instant carries the EXACT instant baked into the stamp
    assert send_ev[0]["ts_ns"] == ctx.send_ns

    recv = {e["name"]: e for e in t_recv.snapshot()}
    assert recv["p2p.msg.recv"]["args"]["origin"] == "n0"
    assert recv["p2p.msg.recv"]["args"]["seq"] == 0
    # same process => same clock domain => live propagation span
    prop = recv["p2p.msg.propagation"]
    assert prop["ts_ns"] == ctx.send_ns and prop["dur_ns"] >= 0

    # a foreign clock domain must NOT produce a propagation span
    t_recv.clear()
    foreign = tracewire.TraceCtx("vote", 1, ctx.send_ns, ctx.clock ^ 0xFFFF, 5, 1, "other")
    receiver.on_receive(foreign, "p")
    names = [e["name"] for e in t_recv.snapshot()]
    assert "p2p.msg.recv" in names
    assert "p2p.msg.propagation" not in names


def test_stamper_skips_payloads_near_channel_cap():
    t = Tracer("s", size=16)
    st = tracewire.TraceStamper(t, origin="n0")
    big = b"x" * 1000
    wire = st.wrap(big, "txs", cap=1000 + tracewire.STAMP_MAX_OVERHEAD - 1)
    assert wire == big  # unstamped: would cross the cap
    assert t.snapshot() == []  # and no phantom send instant
    wire = st.wrap(big, "txs", cap=1000 + tracewire.STAMP_MAX_OVERHEAD)
    assert wire.startswith(tracewire.MAGIC)
    # a magic-prefixed payload near the cap is escaped IF it fits, raw
    # otherwise (never oversized, never misparsed)
    tricky = tracewire.MAGIC + b"y" * 998
    wire = st.wrap(tricky, "txs", cap=1001)
    assert tracewire.unstamp(wire) == (None, tricky)


# --- 3. switch-level interop over MemoryTransport ------------------------


class SinkReactor(Reactor):
    name = "sink"
    CHAN = 0x55

    def __init__(self):
        super().__init__()
        self.got = []

    def get_channels(self):
        return [ChannelDescriptor(self.CHAN, priority=3)]

    def add_peer(self, peer):
        pass

    def remove_peer(self, peer, reason):
        pass

    def receive(self, chan_id, peer, msg):
        self.got.append(bytes(msg))


def _switch(chain_id="tracewire-net"):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network=chain_id)
    sw = Switch(MemoryTransport(nk, info), info)
    rx = sw.add_reactor("sink", SinkReactor())
    return sw, rx


async def _connect(a, b):
    for sw in (a, b):
        await sw.transport.listen()
        await sw.start()
    await a.dial_peer(b.transport.listen_addr)
    for _ in range(100):
        if a.num_peers() and b.num_peers():
            break
        await asyncio.sleep(0.02)


async def _until(cond):
    for _ in range(100):
        if cond():
            return
        await asyncio.sleep(0.02)


def test_switch_interop_stamping_vs_plain_peer():
    """Stamping node <-> non-stamping node: payloads are byte-identical
    in both directions, including one that starts with the magic
    bytes; the stamping side records its send instant, the plain side
    records nothing."""

    async def main():
        sw_new, rx_new = _switch()
        sw_old, rx_old = _switch()
        tr = Tracer("new", size=256)
        sw_new.enable_stamping(tr, "new-node")
        await _connect(sw_new, sw_old)

        tricky = tracewire.MAGIC + b"looks-like-a-stamp"
        sw_new.broadcast(SinkReactor.CHAN, b"stamped-hello", tkind="vote", height=9)
        sw_new.broadcast(SinkReactor.CHAN, b"plain-hello")
        sw_old.broadcast(SinkReactor.CHAN, b"old-hello")
        sw_old.broadcast(SinkReactor.CHAN, tricky)
        await _until(lambda: len(rx_old.got) >= 2 and len(rx_new.got) >= 2)

        assert rx_old.got == [b"stamped-hello", b"plain-hello"]
        assert rx_new.got == [b"old-hello", tricky]
        sends = [e for e in tr.snapshot() if e["name"] == "p2p.msg.send"]
        assert len(sends) == 1 and sends[0]["args"]["kind"] == "vote"
        assert sends[0]["args"]["h"] == 9
        await sw_new.stop()
        await sw_old.stop()

    run(main())


def test_switch_interop_both_stamping_records_recv():
    async def main():
        sw_a, rx_a = _switch()
        sw_b, rx_b = _switch()
        tr_a, tr_b = Tracer("a", size=256), Tracer("b", size=256)
        sw_a.enable_stamping(tr_a, "node-a")
        sw_b.enable_stamping(tr_b, "node-b")
        await _connect(sw_a, sw_b)
        sw_a.broadcast(SinkReactor.CHAN, b"payload", tkind="proposal", height=4, round_=0)
        await _until(lambda: rx_b.got)
        assert rx_b.got == [b"payload"]
        recvs = [e for e in tr_b.snapshot() if e["name"] == "p2p.msg.recv"]
        assert len(recvs) == 1
        a = recvs[0]["args"]
        assert a["origin"] == "node-a" and a["kind"] == "proposal"
        assert a["h"] == 4
        # same process: the live propagation span fired too
        props = [e for e in tr_b.snapshot() if e["name"] == "p2p.msg.propagation"]
        assert props and props[0]["args"]["origin"] == "node-a"
        await sw_a.stop()
        await sw_b.stop()

    run(main())


def test_switch_receive_only_records_arrivals_without_stamping():
    """trace_msg_stamp=False gates only the OUTBOUND stamp: the node's
    own sends go out unstamped, but arrivals from stamping peers are
    still recorded in its ring."""

    async def main():
        sw_rx, rx_rx = _switch()
        sw_tx, rx_tx = _switch()
        tr_rx, tr_tx = Tracer("rx", size=256), Tracer("tx", size=256)
        sw_rx.enable_stamping(tr_rx, "rx-node", outbound=False)
        sw_tx.enable_stamping(tr_tx, "tx-node")
        await _connect(sw_rx, sw_tx)
        sw_tx.broadcast(SinkReactor.CHAN, b"stamped", tkind="vote", height=2)
        sw_rx.broadcast(SinkReactor.CHAN, b"from-rx", tkind="vote", height=2)
        await _until(lambda: rx_rx.got and rx_tx.got)
        assert rx_rx.got == [b"stamped"] and rx_tx.got == [b"from-rx"]
        recvs = [e for e in tr_rx.snapshot() if e["name"] == "p2p.msg.recv"]
        assert len(recvs) == 1 and recvs[0]["args"]["origin"] == "tx-node"
        assert not [e for e in tr_rx.snapshot() if e["name"] == "p2p.msg.send"]
        assert not [e for e in tr_tx.snapshot() if e["name"] == "p2p.msg.recv"]
        await sw_rx.stop()
        await sw_tx.stop()

    run(main())


def test_stamp_msg_disabled_is_identity():
    sw, _ = _switch()
    msg = b"anything"
    assert sw.stamper is None
    assert sw.stamp_msg(0x55, msg, "vote", height=1) is msg


# --- 4. parity with the JAX package --------------------------------------


def test_stamps_byte_equal_to_jax_for_a_fixed_clock_domain():
    rng = np.random.default_rng(15)
    clock = 0x5EED5EED | 1
    for i in range(64):
        payload = rng.bytes(int(rng.integers(0, 300)))
        if i % 7 == 0:
            payload = tracewire.MAGIC + payload
        kind = tracewire.KINDS[i % len(tracewire.KINDS)]
        origin = "node-%d" % i + "x" * int(rng.integers(0, 40))
        args = dict(height=int(rng.integers(0, 1 << 40)), round_=int(rng.integers(-1, 50)),
                    send_ns=int(rng.integers(0, 1 << 62)), clock=clock)
        seq = int(rng.integers(0, 1 << 32))
        mine = tracewire.stamp(payload, kind, seq, origin, **args)
        theirs = jtracewire.stamp(payload, kind, seq, origin, **args)
        assert mine == theirs
        assert tracewire.encode_plain(payload, 400) == jtracewire.encode_plain(payload, 400)
        for ctx, out in (tracewire.unstamp(theirs), jtracewire.unstamp(mine)):
            assert out == payload
            assert (ctx.kind, ctx.seq, ctx.send_ns, ctx.clock, ctx.height, ctx.round, ctx.origin) == (
                kind, seq, args["send_ns"], clock, args["height"], args["round_"], origin[:32])
    assert tracewire.KINDS == jtracewire.KINDS and tracewire.MAGIC == jtracewire.MAGIC
    assert tracewire.STAMP_MAX_OVERHEAD == jtracewire.STAMP_MAX_OVERHEAD


def test_mixed_net_records_and_attributes_each_others_stamps(tmp_path):
    """One port Node and one JAX Node are a 2-validator net over TCP,
    both tracing and stamping. Each ring records stamped arrivals from
    the other's origin, and over the two rings both packages'
    ``attribute_heights`` give every height both committed a complete
    chain with the same proposer and committers."""
    from cometbft_tpu.config.config import test_config as jtest_config
    from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
    from cometbft_tpu.node.node import Node as JNode
    from cometbft_tpu.privval.file_pv import FilePV as JFilePV
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    gen, privs = make_genesis(2, chain_id="stamp-mix", seed=8)
    jgen = JGenesisDoc.from_json(gen.to_json())
    ppv = make_privvals(privs[:1], root=str(tmp_path))[0]
    d = os.path.join(str(tmp_path), "jpv")
    os.makedirs(d)
    jpv = JFilePV(JPriv.from_seed(privs[1].seed), os.path.join(d, "key.json"), os.path.join(d, "state.json"))
    jpv.save_key()
    jpv.save_state()
    pcfg = make_test_cfg(".")
    pcfg.base.moniker = "port0"
    pcfg.blocksync.enable = False
    jcfg = jtest_config(".")
    jcfg.base.moniker = "jax0"
    jcfg.blocksync.enable = False
    jcfg.p2p.laddr = "tcp://127.0.0.1:0"
    jcfg.p2p.pex = False
    jcfg.rpc.laddr = ""

    async def main():
        nodes = [Node(pcfg, gen, privval=ppv, device="cpu"), JNode(jcfg, jgen, privval=jpv)]
        for n in nodes:
            await n.start()
        try:
            await nodes[0].dial(nodes[1].listen_addr)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 60
            while not all(n.height >= 5 for n in nodes):
                assert loop.time() < deadline, "timed out waiting for height 5"
                await asyncio.sleep(0.05)
            top = min(n.height for n in nodes)
        finally:
            for n in nodes:
                await n.stop()
        return nodes, top

    try:
        nodes, top = run(main(), timeout=120)
    finally:
        sched_mod.set_scheduler(None)
        pv.set_engine(None)
        eng.close()
    rings = {"port0": nodes[0].parts.tracer.snapshot(), "jax0": nodes[1].parts.tracer.snapshot()}
    for me, other in (("port0", "jax0"), ("jax0", "port0")):
        origins = {e["args"]["origin"] for e in rings[me] if e["name"] == "p2p.msg.recv"}
        assert origins == {other}, (me, origins)
        kinds = {e["args"]["kind"] for e in rings[me] if e["name"] == "p2p.msg.recv"}
        assert {"proposal", "block_part", "vote"} <= kinds, (me, kinds)
    mine = attribute_heights(rebase(rings)[0])
    theirs = jtrace.attribute_heights(jtrace.rebase(rings)[0])
    assert mine == theirs
    both = [h for h, s in mine.items() if s["committed"] == ["jax0", "port0"] and h <= top]
    assert both and set(range(2, top + 1)) <= set(both), sorted(mine)
    assert all(mine[h]["complete"] for h in both), {h: mine[h]["missing_arrival"] for h in both}
    assert {mine[h]["proposer"] for h in both} == {"jax0", "port0"}
