"""The port's full node over the network: real consensus over the real
p2p stack (TCP loopback, encrypted + multiplexed), tx gossip through
the mempool reactor, late nodes catching up through the blocksync net
reactor and then joining consensus. The JAX package's
tests/test_node_net.py, case for case, on cometbft_tpu_torch's Node
with ``device="cpu"``, plus the late node in adaptive-sync mode, where
blocksync ingests into the running consensus state machine.
Reference analog: consensus/reactor_test.go nets via
p2p.MakeConnectedSwitches."""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from torch_hard_limit import hard_limit  # noqa: F401

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


def _genesis(n, chain_id, tmp_path):
    gen, privs = make_genesis(n, chain_id=chain_id)
    return gen, make_privvals(privs, root=str(tmp_path))


def _mk_node(gen, pv_, i, blocksync=False, adaptive=False):
    cfg = make_test_cfg(".")
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.base.moniker = f"node{i}"
    cfg.blocksync.enable = blocksync
    cfg.blocksync.adaptive_sync = adaptive
    if not blocksync:
        cfg.blocksync.enable = False
    return Node(cfg, gen, privval=pv_, device="cpu")


async def _connect_all(nodes):
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            await a.dial(b.listen_addr)
    for n in nodes:
        for _ in range(200):
            if n.switch.num_peers() >= len(nodes) - 1:
                break
            await asyncio.sleep(0.05)


async def _wait_height(nodes, h, timeout=60):
    async def waiter():
        while not all(n.height >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(waiter(), timeout)


def test_consensus_over_tcp_net(tmp_path):
    gen, pvs = _genesis(N_VALS, "net-chain", tmp_path)

    async def main():
        nodes = [_mk_node(gen, p, i) for i, p in enumerate(pvs)]
        for n in nodes:
            await n.start()
        await _connect_all(nodes)
        await _wait_height(nodes, 3)
        # all nodes agree on block 2
        h2 = {bytes(n.parts.block_store.load_block(2).hash()) for n in nodes}
        assert len(h2) == 1
        # peer votes reached the state machines through the reactors'
        # coalescers, and no route failed
        assert all(n.consensus_reactor.vote_verifier.submitted > 0 for n in nodes)
        assert all(n.parts.cs.loop_errors.count == 0 for n in nodes)
        for n in nodes:
            await n.stop()

    run(main())


def test_tx_gossip_reaches_blocks(tmp_path):
    gen, pvs = _genesis(N_VALS, "txg-chain", tmp_path)

    async def main():
        nodes = [_mk_node(gen, p, i) for i, p in enumerate(pvs)]
        for n in nodes:
            await n.start()
        await _connect_all(nodes)
        # submit a tx at node 3 only; it must end up in some block
        nodes[3].parts.mempool.check_tx(b"gossip=works")
        await _wait_height(nodes, 2)

        async def tx_committed():
            while True:
                for n in nodes:
                    for h in range(1, n.height + 1):
                        blk = n.parts.block_store.load_block(h)
                        if blk and b"gossip=works" in blk.data.txs:
                            return h
                await asyncio.sleep(0.05)

        h = await asyncio.wait_for(tx_committed(), 30)
        assert h >= 1
        for n in nodes:
            await n.stop()

    run(main())


@pytest.mark.parametrize("adaptive", [False, True], ids=["switch", "adaptive"])
def test_late_node_blocksyncs_then_joins_consensus(tmp_path, adaptive):
    gen, pvs = _genesis(N_VALS, "late-chain", tmp_path)

    async def main():
        vals = [_mk_node(gen, p, i) for i, p in enumerate(pvs[:3])]
        for n in vals:
            await n.start()
        await _connect_all(vals)
        # 3 of 4 validators hold 30/40 of the power: +2/3
        await _wait_height(vals, 4)

        late = _mk_node(gen, pvs[3], 3, blocksync=True, adaptive=adaptive)
        ingested = []
        if adaptive:
            real = late.parts.cs.ingest_verified_block

            def ingest(block, parts, commit):
                ingested.append(block.height)
                return real(block, parts, commit)

            late.parts.cs.ingest_verified_block = ingest
        await late.start()
        # adaptive: consensus runs from the start, fed by blocksync
        assert late._cs_started == adaptive
        for v in vals:
            await late.dial(v.listen_addr)
        # late node must catch up and then participate in consensus
        target = max(v.height for v in vals) + 3
        await _wait_height([late], target, timeout=90)
        assert late._cs_started
        # its blocks match the others
        blk = late.parts.block_store.load_block(2)
        assert bytes(blk.hash()) == bytes(vals[0].parts.block_store.load_block(2).hash())
        if adaptive:
            # every block it did not vote on entered consensus through
            # ingest_verified_block (blocksync windows or catch-up
            # CommitBlocks), in height order from 1
            assert ingested[:3] == [1, 2, 3]
            assert ingested == sorted(ingested)
        assert late.parts.cs.loop_errors.count == 0
        for n in vals + [late]:
            await n.stop()

    run(main())


@pytest.mark.parametrize("absent", [(), (3,)], ids=["whole", "one-absent"])
def test_vote_wave_closes_whole_or_after_two_thirds(absent):
    """Stub validators play two heights over TCP to a node with no
    signer. Each wave goes to the reactor's coalescer as one dispatch:
    at once when every validator's vote is in, else once +2/3 of the
    power is in and a grace as long as it took to get there has passed,
    never after the coalescer's window (set here far beyond the test's
    deadline). A height whose waves lack one validator commits without
    it. A re-sent copy of a vote the state machine holds goes straight
    to it, not to the coalescer."""
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.utils.chaingen import StubPeer, ValidatorStubs

    gen, privs = make_genesis(N_VALS, chain_id="wave-close")
    shadow = build_node(gen, device="cpu")
    stubs = ValidatorStubs(shadow, privs)
    cfg = make_test_cfg(".")
    cfg.blocksync.enable = False
    cfg.consensus.skip_timeout_commit = True
    cfg.consensus.timeout_propose_s = 60.0  # no timeout while a height is played
    n_in = N_VALS - len(absent)
    heights = (1, 2)

    async def until(cond):
        for _ in range(400):
            if cond():
                return
            await asyncio.sleep(0.05)

    async def main():
        node = Node(cfg, gen, device="cpu")
        cs, reactor = node.parts.cs, node.consensus_reactor
        reactor.vote_verifier.window_s = 600.0
        await node.start()
        stub = StubPeer(gen.chain_id)
        try:
            await stub.connect(node.listen_addr)
            await until(lambda: node.switch.num_peers() == 1)
            for h in heights:
                await until(lambda: cs.rs.height == h and int(cs.rs.step) >= 3)
                m = stubs.messages(h)
                deliver = stub.deliver_for(m)
                deliver("proposal", m.proposal)
                for part in m.parts:
                    deliver("block_part", part)
                await until(lambda: cs.rs.proposal_block is not None)
                stub.send_votes([v for v in m.prevotes if v.validator_index not in absent])
                await until(lambda: sum(v is not None for v in cs.rs.votes.prevotes(0).votes) == n_in)
                stub.send_votes([v for v in m.prevotes if v.validator_index not in absent])
                stub.send_votes([v for v in m.precommits if v.validator_index not in absent])
                await _wait_height([node], h, timeout=60)
                assert node.block_id_hash_at(h) == m.block.hash()
                stubs.finish(m)
            how = "grace" if absent else "whole"
            assert [e[:5] for e in reactor.wave_log] == [
                (h, 0, t, how, n_in) for h in heights
                for t in (m.prevotes[0].type_, m.precommits[0].type_)
            ]
            assert reactor.vote_verifier.dispatches == 2 * len(heights)
            assert reactor.vote_verifier.submitted == 2 * n_in * len(heights)
            assert cs.loop_errors.count == 0
        finally:
            await stub.stop()
            await node.stop()
            shadow.close_stores()

    run(main())
