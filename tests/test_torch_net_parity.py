"""The port's network layer against the JAX package's, on the CPU.

- Bytes: messages made once from a seeded chain (4 validators) encode
  byte-identically in both packages, and each package's reactor decodes
  the other's: every consensus reactor message (round step, HasVote,
  HasPart, proposal, block part, vote, CommitBlock), the blocksync net
  messages (status request and response, block request, block and
  no-block response), the mempool codec's batches and MConnection's
  packets.
- Handshake: a port SecretConnection and a JAX one complete the STS
  handshake over a loopback socket pair, learn each other's identity
  and carry frames both ways; a tampered frame is refused on each side.
- A mixed net: two JAX Nodes and two port Nodes (``device="cpu"``) are
  one 4-validator net over TCP; they reach height 4 with the same block
  at every height, and a tx submitted at a port node is committed. The
  JAX nodes share the port's event loop; their PEX reactor is off and
  their RPC server unused.
- Replay cross-check: the blocks a 4-validator port net makes over TCP
  replay through the JAX package's BlockSyncReactor with the port
  nodes' states and app hashes at every height.

The JAX package runs on its "cpu" backend (tests/conftest.py).
"""

import asyncio
import os
import random
import socket
import struct
import tempfile

import numpy as np
import pytest
import torch

from cometbft_tpu.blocksync import net_reactor as jbs
from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor
from cometbft_tpu.config.config import test_config as jtest_config
from cometbft_tpu.consensus import reactor as jcr
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.mempool import codec as jmcodec
from cometbft_tpu.node.inprocess import build_node as jbuild_node
from cometbft_tpu.node.node import Node as JNode
from cometbft_tpu.p2p.conn import connection as jconn
from cometbft_tpu.p2p.conn.secret_connection import SecretConnection as JSecretConnection
from cometbft_tpu.p2p.key import node_id_from_pubkey as jnode_id
from cometbft_tpu.privval.file_pv import FilePV as JFilePV
from cometbft_tpu.store.block_store import _decode_part as jdecode_part
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.types.part_set import PartSet as JPartSet
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.blocksync import net_reactor as pbs
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.consensus import reactor as pcr
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.mempool import codec as pmcodec
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.p2p.conn import connection as pconn
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.key import node_id_from_pubkey
from cometbft_tpu_torch.store.block_store import _encode_part
from cometbft_tpu_torch.utils import chaingen, codec
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
SEED = 8
N_VALS = 4


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def chain():
    """A seeded 4-validator port chain of 3 blocks (2 txs a block, one
    of them beginning with the stamp magic) and the stubs' messages for
    height 4."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(N_VALS, chain_id="net-parity", seed=SEED)
        src = chaingen.make_chain(gen, privs, 3, txs_per_block=2, device=CPU)
        src.mempool.check_tx(b"\xb7\x54magic=prefixed")
        m = chaingen.ValidatorStubs(src, privs).messages(4)
    finally:
        pv.set_engine(None)
        eng.close()
    return gen, privs, src, m


class _Capture:
    """A peer that records what a reactor sends it."""

    peer_id = "ab" * 20

    def __init__(self):
        self.sent = []
        self._data = {}

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, bytes(msg)))
        return True

    async def send(self, chan_id, msg):
        return self.try_send(chan_id, msg)

    def get(self, k, default=None):
        return self._data.get(k, default)

    def set(self, k, v):
        self._data[k] = v


def _jblock(b):
    return jcodec.decode_block(codec.encode_block(b))


def _jcommit(c):
    return jcodec.decode_commit(codec.encode_commit(c))


# --- bytes -------------------------------------------------------------------


def test_consensus_messages_are_byte_identical(chain):
    gen, _, src, m = chain
    rng = random.Random(SEED)
    for _ in range(20):
        h, r, s, i = rng.randrange(1, 1 << 40), rng.randrange(0, 50), rng.randrange(1, 9), rng.randrange(0, 150)
        assert pcr.encode_new_round_step(h, r, s) == jcr.encode_new_round_step(h, r, s)
        assert pcr.encode_has_vote(h, r, 1 + (s & 1), i) == jcr.encode_has_vote(h, r, 1 + (s & 1), i)
        assert pcr.encode_has_part(h, r, i) == jcr.encode_has_part(h, r, i)
    p = pcr.encode_proposal_msg(m.proposal)
    assert p == jcr.encode_proposal_msg(jcodec.decode_proposal(p[1:]))
    for part in m.parts:
        b = pcr.encode_block_part_msg(m.height, m.round, part)
        assert b == jcr.encode_block_part_msg(m.height, m.round, jdecode_part(_encode_part(part)))
    for v in m.prevotes + m.precommits:
        b = pcr.encode_vote_msg(v)
        assert b == jcr.encode_vote_msg(jcodec.decode_vote(b[1:]))
    for h in (1, 3):
        blk, seen = src.block_store.load_block(h), src.block_store.load_seen_commit(h)
        assert pcr.encode_commit_block(blk, seen) == jcr.encode_commit_block(_jblock(blk), _jcommit(seen))
        ec = b"\x0a\x03ext"
        assert pcr.encode_commit_block(blk, seen, ec) == jcr.encode_commit_block(_jblock(blk), _jcommit(seen), ec)
    assert (pcr.STATE_CHANNEL, pcr.DATA_CHANNEL, pcr.VOTE_CHANNEL) == (jcr.STATE_CHANNEL, jcr.DATA_CHANNEL,
                                                                       jcr.VOTE_CHANNEL)


def _captured_cs(cs):
    got = []
    cs.enqueue_nowait = lambda kind, payload, peer_id: got.append((kind, payload))
    return got


def test_each_consensus_reactor_decodes_the_others_messages(chain):
    """The JAX package's bytes through the port reactor's receive, and
    the port's through the JAX reactor's: the same messages reach each
    state machine, and both acknowledge with the same bytes."""
    gen, privs, src, m = chain
    jgen = JGenesisDoc.from_json(gen.to_json())
    port = pcr.ConsensusReactor(build_node(gen, device=CPU).cs, src.block_store)
    jnode = jbuild_node(jgen, None)
    jax = jcr.ConsensusReactor(jnode.cs, jnode.block_store)
    port_got, jax_got = _captured_cs(port.cs), _captured_cs(jax.cs)
    blk, seen = src.block_store.load_block(3), src.block_store.load_seen_commit(3)
    jmsgs = [
        (pcr.DATA_CHANNEL, jcr.encode_proposal_msg(jcodec.decode_proposal(codec.encode_proposal(m.proposal)))),
        *[(pcr.DATA_CHANNEL, jcr.encode_block_part_msg(m.height, m.round, jdecode_part(_encode_part(pt))))
          for pt in m.parts],
        *[(pcr.VOTE_CHANNEL, jcr.encode_vote_msg(jcodec.decode_vote(codec.encode_vote(v)))) for v in m.prevotes],
        (pcr.DATA_CHANNEL, jcr.encode_commit_block(_jblock(blk), _jcommit(seen))),
    ]
    pmsgs = [
        (pcr.DATA_CHANNEL, pcr.encode_proposal_msg(m.proposal)),
        *[(pcr.DATA_CHANNEL, pcr.encode_block_part_msg(m.height, m.round, pt)) for pt in m.parts],
        *[(pcr.VOTE_CHANNEL, pcr.encode_vote_msg(v)) for v in m.prevotes],
        (pcr.DATA_CHANNEL, pcr.encode_commit_block(blk, seen)),
    ]
    assert [b for _, b in jmsgs] == [b for _, b in pmsgs]
    pp, jp = _Capture(), _Capture()
    for (chan, jb), (_, pb) in zip(jmsgs, pmsgs):
        port.receive(chan, pp, jb)
        jax.receive(chan, jp, pb)
    assert [k for k, _ in port_got] == [k for k, _ in jax_got]
    assert [k for k, _ in port_got] == ["proposal"] + ["block_part"] * len(m.parts) + ["vote"] * N_VALS + [
        "commit_block"]
    assert codec.encode_proposal(port_got[0][1].proposal) == codec.encode_proposal(m.proposal)
    for (_, pmsg), (_, jmsg) in zip(port_got[1:], jax_got[1:]):
        if hasattr(pmsg, "vote"):
            assert codec.encode_vote(pmsg.vote) == jcodec.encode_vote(jmsg.vote)
        elif hasattr(pmsg, "part"):
            assert _encode_part(pmsg.part) == _encode_part(jdecode_part(_encode_part(pmsg.part)))
            assert pmsg.part.index == jmsg.part.index and pmsg.height == jmsg.height
    assert codec.encode_block(port_got[-1][1].block) == jcodec.encode_block(jax_got[-1][1].block)
    # the acknowledgements (HasPart, HasVote) are the same bytes, in order
    assert pp.sent == jp.sent and len(pp.sent) == len(m.parts) + N_VALS


def test_blocksync_messages_are_byte_identical(chain):
    gen, _, src, _ = chain
    jgen = JGenesisDoc.from_json(gen.to_json())
    jsrc = jbuild_node(jgen, None)
    for h in range(1, src.block_store.height() + 1):
        blk = jcodec.decode_block(codec.encode_block(src.block_store.load_block(h)))
        jsrc.block_store.save_block(blk, JPartSet.from_data(blk._raw_bytes),
                                    _jcommit(src.block_store.load_seen_commit(h)))
    port = pbs.BlockSyncNetReactor(src.state, src.block_exec, src.block_store, active=False, device=CPU)
    jax = jbs.BlockSyncNetReactor(jsrc.state, jsrc.block_exec, jsrc.block_store, active=False)
    assert port._status_response() == jax._status_response()
    assert pbs.BLOCKSYNC_CHANNEL == jbs.BLOCKSYNC_CHANNEL

    async def main():
        out = {}
        for name, r in (("port", port), ("jax", jax)):
            peer = _Capture()
            r.add_peer(peer)
            for h in (2, 3, 9):
                r.receive(pbs.BLOCKSYNC_CHANNEL, peer, bytes([pbs.MSG_BLOCK_REQUEST]) + struct.pack(">q", h))
            r.receive(pbs.BLOCKSYNC_CHANNEL, peer, bytes([pbs.MSG_STATUS_REQUEST]))
            await asyncio.sleep(0.05)  # block responses go out from a task
            # the request a pool sends through the net client
            cli = (pbs if name == "port" else jbs).NetPeerClient(peer)
            t = asyncio.ensure_future(cli.request_block(2))
            await asyncio.sleep(0.01)
            cli.deliver(2, None)
            await t
            out[name] = peer.sent
        return out

    out = run(main())
    assert out["port"] == out["jax"] and len(out["port"]) == 6
    # each decodes the other's block response
    resp = [b for _, b in out["jax"] if b[0] == pbs.MSG_BLOCK_RESPONSE][0]
    got = {}
    peer = _Capture()
    port.clients[peer.peer_id] = type("C", (), {"deliver": lambda self, h, b: got.setdefault(h, b)})()
    port.receive(pbs.BLOCKSYNC_CHANNEL, peer, resp)
    assert codec.encode_block(got[2]) == jcodec.encode_block(jsrc.block_store.load_block(2))


def test_mempool_batches_are_byte_identical():
    rng = np.random.default_rng(SEED)
    cases = [[b"k=v"], [b"\xb7\x30starts-with-magic"], [bytes(rng.bytes(int(n))) for n in rng.integers(1, 300, 40)],
             [b"a", b"b" * 200, b"\xb7\x30"]]
    for txs in cases:
        wire = pmcodec.encode_txs(txs)
        assert wire == jmcodec.encode_txs(txs)
        assert pmcodec.encode_batch(txs) == jmcodec.encode_batch(txs)
        assert pmcodec.decode_txs(jmcodec.encode_txs(txs)) == txs
        assert jmcodec.decode_txs(wire) == txs
    assert pmcodec.decode_txs(b"\xb7\x30\x05garbage") == jmcodec.decode_txs(b"\xb7\x30\x05garbage")


def test_mconnection_packets_are_byte_identical():
    msgs = [(0x22, b"vote" * 40), (0x21, bytes(range(256)) * 9), (0x20, b""), (0x30, b"x" * 3000),
            (0x21, b"p")]
    chans = [(0x20, 6), (0x21, 10), (0x22, 7), (0x30, 5)]

    async def packets(mod):
        mc = mod.MConnection(None, chans, on_receive=lambda c, m: None)
        for cid, msg in msgs:
            assert mc.try_send(cid, msg)
        out = []
        while (pkt := mc._next_packet()) is not None:
            out.append(pkt)
        return out

    port, jax = run(packets(pconn)), run(packets(jconn))
    assert port == jax and len(port) == 9
    assert (pconn.PACKET_PING, pconn.PACKET_PONG, pconn.PACKET_MSG) == (jconn.PACKET_PING, jconn.PACKET_PONG,
                                                                       jconn.PACKET_MSG)


# --- handshake ---------------------------------------------------------------


def test_secret_connection_handshake_across_packages():
    async def main():
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        ra, wa = await asyncio.open_connection(sock=a)
        rb, wb = await asyncio.open_connection(sock=b)
        pk = Ed25519PrivKey.from_seed(bytes(range(32)))
        jk = JPriv.from_seed(bytes(range(7, 39)))
        pc, jc = await asyncio.gather(
            SecretConnection.handshake(ra, wa, pk),
            JSecretConnection.handshake(rb, wb, jk),
        )
        assert pc.remote_pubkey.key_bytes == jk.pub_key().key_bytes
        assert jc.remote_pubkey.key_bytes == pk.pub_key().key_bytes
        assert node_id_from_pubkey(pc.remote_pubkey) == jnode_id(jk.pub_key())
        assert jnode_id(jc.remote_pubkey) == node_id_from_pubkey(pk.pub_key())
        big = bytes(range(256)) * 20
        for src, dst in ((pc, jc), (jc, pc)):
            await src.write_msg(b"hello")
            assert await dst.read_chunk() == b"hello"
            await src.write_msg(big)
            got = b""
            while len(got) < len(big):
                got += await dst.read_chunk()
            assert got == big
        # a tampered frame is refused on each side
        for src, dst in ((pc, jc), (jc, pc)):
            sealed = src._seal(b"payload")
            with pytest.raises(Exception):
                dst._open(bytes([sealed[0] ^ 0xFF]) + sealed[1:])
        pc.close()
        jc.close()

    run(main(), timeout=30)


# --- a mixed net -------------------------------------------------------------


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


def test_mixed_net_of_jax_and_port_nodes(tmp_path):
    gen, privs = make_genesis(N_VALS, chain_id="mixed-net", seed=SEED)
    jgen = JGenesisDoc.from_json(gen.to_json())
    ppvs = make_privvals(privs[:2], root=str(tmp_path))
    jpvs = _jax_privvals(privs[2:], str(tmp_path))

    def pcfg(i):
        c = make_test_cfg(".")
        c.base.moniker = f"port{i}"
        c.blocksync.enable = False
        return c

    def jcfg(i):
        c = jtest_config(".")
        c.base.moniker = f"jax{i}"
        c.blocksync.enable = False
        c.p2p.laddr = "tcp://127.0.0.1:0"
        c.p2p.pex = False
        c.rpc.laddr = ""
        return c

    async def main():
        nodes = [Node(pcfg(i), gen, privval=p, device=CPU) for i, p in enumerate(ppvs)]
        nodes += [JNode(jcfg(i), jgen, privval=p) for i, p in enumerate(jpvs)]
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await _wait(lambda: all(n.switch.num_peers() == 3 for n in nodes), "the full mesh")
            assert nodes[0].parts.mempool.check_tx(b"mixed=net").is_ok()
            await _wait(lambda: all(n.height >= 4 for n in nodes), "height 4")

            def committed():
                return any(b"mixed=net" in n.parts.block_store.load_block(h).data.txs
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


# --- replay cross-check ------------------------------------------------------


def _state_row(st):
    return (st.last_block_height, bytes(st.app_hash), bytes(st.last_results_hash), st.validators.hash(),
            st.next_validators.hash(), st.last_block_id.key())


def test_port_net_blocks_replay_through_jax_blocksync(tmp_path):
    gen, privs = make_genesis(N_VALS, chain_id="net-replay", seed=SEED)
    pvs = make_privvals(privs, root=str(tmp_path))
    rows = {}

    def mk(i):
        c = make_test_cfg(".")
        c.base.moniker = f"node{i}"
        c.blocksync.enable = False
        return Node(c, gen, privval=pvs[i], device=CPU)

    async def net():
        nodes = [mk(i) for i in range(N_VALS)]
        real = nodes[0].parts.block_exec.apply_verified_block

        def record(state, bid, block):
            st = real(state, bid, block)
            rows[st.last_block_height] = _state_row(st)
            return st

        nodes[0].parts.block_exec.apply_verified_block = record
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            for k in range(8):
                nodes[k % N_VALS].parts.mempool.check_tx(b"replay%d=v" % k)
            await _wait(lambda: all(n.height >= 6 for n in nodes), "height 6")
        finally:
            for n in nodes:
                await n.stop()
        return nodes[0]

    node = run(net(), timeout=120)
    top = node.height
    # the port net's chain, moved as bytes into a JAX store
    jgen = JGenesisDoc.from_json(gen.to_json())
    jsrc = jbuild_node(jgen, None)
    for h in range(1, top + 1):
        blk = jcodec.decode_block(codec.encode_block(node.parts.block_store.load_block(h)))
        jsrc.block_store.save_block(blk, JPartSet.from_data(blk._raw_bytes),
                                    _jcommit(node.parts.block_store.load_seen_commit(h)))
    assert sum(len(jsrc.block_store.load_block(h).data.txs) for h in range(1, top + 1)) >= 8

    async def replay():
        fresh = jbuild_node(jgen, None)
        jrows = {}
        real = fresh.block_exec.apply_verified_block

        def record(state, bid, block):
            st = real(state, bid, block)
            jrows[st.last_block_height] = _state_row(st)
            return st

        fresh.block_exec.apply_verified_block = record
        caught = asyncio.Event()
        r = JReactor(fresh.state, fresh.block_exec, fresh.block_store, on_caught_up=lambda st: caught.set())
        r.pool.set_peer_range("port", jchaingen.StorePeerClient(jsrc), 1, top)
        await r.start()
        await asyncio.wait_for(caught.wait(), 60)
        await r.stop()
        return jrows

    jrows = run(replay())
    common = sorted(set(rows) & set(jrows))
    assert len(common) >= top - 2
    assert all(rows[h] == jrows[h] for h in common)
