"""A failed card on the network path is never a verdict (ROADMAP C3).

The JAX package turns any exception at two network sites into a
verdict: the consensus reactor's vote-wave callback drops the vote as
forged (cometbft_tpu/consensus/reactor.py ``_submit_vote``), and the
switch stops the peer whose message a reactor failed to handle
(cometbft_tpu/p2p/switch.py ``_dispatch``). In the port a
``crypto.scheduler.DeviceRouteError`` at either site is counted in the
state machine's ``loop_errors``: the vote is not called forged, not
checked on the host and not acknowledged, and the peer stays
connected. Once the card works again the unacknowledged votes, re-sent
as a peer's gossip routine re-sends them, let the height commit.

The card is a stand-in with the device route pinned (the ``card``
fixture's pattern from test_torch_consensus_parity.py): a fault makes
the scheduler's device dispatch of every ``vote-wave`` ticket (the
reactor's coalescer) raise a RuntimeError, a ValueError or an OSError;
working, it answers each lane with the host's single ZIP-215 check
(``Ed25519PubKey.verify``), since the plain kernels on the CPU take
about a second a dispatch and a four-node net dispatches many.
"""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.p2p import ChannelDescriptor, NodeInfo, NodeKey, Reactor, Switch, TCPTransport
from cometbft_tpu_torch.utils.chaingen import StubPeer, ValidatorStubs
from torch_hard_limit import hard_limit  # noqa: F401

FAULTS = [RuntimeError("card lost"), ValueError("bad launch config"), OSError(5, "I/O error")]
FAULT_IDS = ["RuntimeError", "ValueError", "OSError"]
FORGED_LOG = "dropping vote with invalid signature"


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_min_device_batch(floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


class _Answered:
    """A device handle that is already resolved."""

    def __init__(self, oks):
        self.oks = oks
        self.dispatch = {}

    def wait(self):
        pass

    def result(self):
        return self.oks


@pytest.fixture
def card(monkeypatch):
    """The device route pinned on a stand-in card; ``card["fault"] =
    <error>`` makes the device dispatch of every ``vote-wave`` ticket
    raise it."""
    real = sched_mod.VerifyScheduler._dispatch_device
    state = {"fault": None, "failed": 0, "dispatched": 0}

    def dispatch(self, ticket, ed_idx, ed_items):
        if state["fault"] is not None and ticket.label == "vote-wave":
            state["failed"] += 1
            raise state["fault"]
        return real(self, ticket, ed_idx, ed_items)

    def answer(items, device=None, precomp=None):
        state["dispatched"] += 1
        return _Answered([Ed25519PubKey(pk).verify(m, sig) for m, pk, sig in items])

    monkeypatch.setattr(sched_mod.VerifyScheduler, "_dispatch_device", dispatch)
    monkeypatch.setattr(ops_ed, "verify_batch_async", answer)
    crypto_batch.set_min_device_batch(1)
    return state


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, what, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def _added(votes):
    return sum(v is not None for v in votes.votes)


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_failed_wave_is_no_verdict_and_the_peer_stays(card, fault, capsys):
    """The stubs' prevote wave reaches the node over TCP while the card
    fails: no vote is added, logged as forged, acknowledged or checked
    on the host, every one is counted, and the stub peer stays
    connected. With the card back, the unacknowledged votes re-sent
    (a peer's gossip routine does so) and the precommits let the
    height commit with the stubs' block."""
    gen, privs = make_genesis(4, chain_id="c3-wave")
    shadow = build_node(gen, device="cpu")
    stubs = ValidatorStubs(shadow, privs)
    cfg = make_test_cfg(".")
    cfg.blocksync.enable = False
    cfg.consensus.skip_timeout_commit = True
    cfg.consensus.timeout_propose_s = 60.0  # no timeout while the height is played

    async def main():
        node = Node(cfg, gen, device="cpu")
        cs = node.parts.cs
        await node.start()
        stub = StubPeer(gen.chain_id)
        try:
            await stub.connect(node.listen_addr)
            await _until(lambda: node.switch.num_peers() == 1, "the stub peer")
            m = stubs.messages(1)
            deliver = stub.deliver_for(m)
            await _until(lambda: cs.rs.height == 1 and int(cs.rs.step) >= 3, "the propose step")
            deliver("proposal", m.proposal)
            for part in m.parts:
                deliver("block_part", part)
            await _until(lambda: cs.rs.proposal_block is not None, "the proposal's block")

            card["fault"] = fault
            stub.send_votes(m.prevotes)
            n = len(m.prevotes)
            await _until(lambda: cs.loop_errors.count >= n, "the failed wave to be counted")
            await asyncio.sleep(0.2)  # any acknowledgement would be on its way by now
            assert card["failed"] >= 1
            assert cs.loop_errors.count == n
            assert all(isinstance(e, DeviceRouteError) for e in cs.loop_errors.kept())
            assert all(e.__cause__ is fault for e in cs.loop_errors.kept())
            assert _added(cs.rs.votes.prevotes(0)) == 0
            assert not any(stub.acknowledged(v) for v in m.prevotes)
            assert node.switch.num_peers() == 1 and stub.switch.num_peers() == 1
            assert sched_mod.scheduler().host_chunks == 0
            assert FORGED_LOG not in capsys.readouterr().err

            card["fault"] = None
            stub.send_votes([v for v in m.prevotes if not stub.acknowledged(v)])
            await _until(lambda: _added(cs.rs.votes.prevotes(0)) == n, "the re-sent prevotes")
            stub.send_votes(m.precommits)
            await _until(lambda: node.height >= 1, "the height to commit")
            assert card["dispatched"] >= 2  # the two waves went to the card
            await _until(lambda: all(stub.acknowledged(v) for v in m.prevotes), "the acknowledgements")
            assert node.block_id_hash_at(1) == m.block.hash()
            assert node.switch.num_peers() == 1 and node.switch.reconnect.flaps_total == 0
            assert sched_mod.scheduler().host_chunks == 0
            assert cs.loop_errors.count == n
            assert FORGED_LOG not in capsys.readouterr().err
        finally:
            await stub.stop()
            await node.stop()

    run(main())


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_net_recovers_from_failed_waves_by_gossip(card, fault, capsys):
    """Four validators over TCP: the first vote waves' route fails on
    whichever node dispatches them. No peer is dropped, no vote is
    called forged, and once the card works the peers' gossip routines
    re-send the unacknowledged votes: every node reaches height 4 with
    the same blocks."""
    gen, privs = make_genesis(4, chain_id="c3-net")
    pvs = make_privvals(privs)

    def mk(i):
        cfg = make_test_cfg(".")
        cfg.base.moniker = f"node{i}"
        cfg.blocksync.enable = False
        return Node(cfg, gen, privval=pvs[i], device="cpu")

    async def main():
        nodes = [mk(i) for i in range(4)]
        card["fault"] = fault
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await _until(lambda: all(n.switch.num_peers() == 3 for n in nodes), "the full mesh")
            await _until(lambda: card["failed"] >= 6, "six failed waves")
            card["fault"] = None
            await _until(lambda: all(n.height >= 4 for n in nodes), "height 4", timeout=60)
            assert sum(n.parts.cs.loop_errors.count for n in nodes) > 0
            assert all(n.switch.num_peers() == 3 for n in nodes)
            assert all(n.switch.reconnect.flaps_total == 0 for n in nodes)
            assert len({n.block_id_hash_at(h) for n in nodes for h in (1, 2, 3, 4)}) == 4
            assert sched_mod.scheduler().host_chunks == 0
            assert FORGED_LOG not in capsys.readouterr().err
        finally:
            for n in nodes:
                await n.stop()

    run(main())


class _FaultyReactor(Reactor):
    name = "faulty"
    CHAN = 0x77

    def __init__(self, exc=None):
        super().__init__()
        self.exc = exc
        self.got = []
        self.removed = []

    def get_channels(self):
        return [ChannelDescriptor(self.CHAN, priority=3)]

    def remove_peer(self, peer, reason):
        self.removed.append(peer.peer_id)

    def receive(self, chan_id, peer, msg):
        self.got.append(msg)
        if msg.startswith(b"fail") and self.exc is not None:
            raise self.exc


def _switch(exc=None):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network="c3-switch")
    sw = Switch(TCPTransport(nk, info), info)
    r = sw.add_reactor("faulty", _FaultyReactor(exc))
    return sw, r


@pytest.mark.parametrize("cause", FAULTS, ids=FAULT_IDS)
def test_switch_keeps_a_peer_whose_message_met_a_failed_route(cause):
    """A reactor that raises DeviceRouteError from ``receive`` does not
    get its peer stopped: the error is counted in ``loop_errors`` and
    the next message is handled. Any other error stops the peer, as in
    the JAX package."""
    err = DeviceRouteError("verify route failed (4 lanes)")
    err.__cause__ = cause

    async def main():
        sw1, r1 = _switch()
        sw2, r2 = _switch(err)
        sw3, r3 = _switch(cause)
        for sw in (sw1, sw2, sw3):
            await sw.transport.listen("127.0.0.1:0")
            await sw.start()
        try:
            p2 = await sw1.dial_peer(sw2.transport.listen_addr)
            p3 = await sw1.dial_peer(sw3.transport.listen_addr)
            await _until(lambda: sw2.num_peers() == 1 and sw3.num_peers() == 1, "both peers")
            for p in (p2, p3):
                p.try_send(_FaultyReactor.CHAN, b"fail-1")
                p.try_send(_FaultyReactor.CHAN, b"next")
            await _until(lambda: len(r2.got) == 2, "both messages at the failed route")
            assert sw2.loop_errors.count == 1 and sw2.loop_errors.kept() == [err]
            assert sw2.num_peers() == 1 and not r2.removed
            # the plain error stops the peer (the JAX handling)
            await _until(lambda: sw3.num_peers() == 0, "the peer with the plain error to go")
            assert r3.got[0] == b"fail-1" and r3.removed
            assert sw3.loop_errors.count == 0
            assert sw1.num_peers() >= 1 and sw2.num_peers() == 1
        finally:
            for sw in (sw1, sw2, sw3):
                await sw.stop()

    run(main())
