"""The port's self-healing connectivity plane (p2p/reconnect.py and the
switch's duplicate-connection resolution): every case of the JAX
package's tests/test_p2p_reconnect.py, on cometbft_tpu_torch.p2p.

1. Lane mechanics: fast-lane budget -> slow-lane park -> the sweep
   reconnects after heal; backoff reset on success; counters and the
   ``p2p.reconnect`` span.
2. A persistent dial that fails at boot lands on the plane.
3. Incarnation-safe dialing: a restarted remote's fresh dial evicts the
   zombie entry; an acceptor's redial beats a long-established zombie;
   simultaneous cross-dials resolve deterministically.
4. Starvation: the next dial success fires a PEX request that bypasses
   the rate limit.
5. lp2p parity: the healed-minority scenario over ``Lp2pSwitch``, which
   inherits the plane.
6. The RPC ``health`` route's connectivity verdict.

Links are partitioned with the port's chaos ``LinkTable``
(``chaos/links.py``), as the JAX tests use the JAX one: it refuses
dials across the partition and blackholes writes on live links, and
the scenarios kill live connections themselves, as the JAX ones do.
"""

import asyncio

from cometbft_tpu_torch.chaos.links import LinkTable
from cometbft_tpu_torch.lp2p import Lp2pSwitch
from cometbft_tpu_torch.p2p import ChannelDescriptor, MemoryTransport, NodeInfo, NodeKey, Reactor, Switch
from cometbft_tpu_torch.trace import Tracer
from torch_hard_limit import hard_limit  # noqa: F401


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# small budgets so a test crosses fast lane -> slow lane in well under
# a second instead of minutes
FAST_RECONNECT = {
    "base_s": 0.02,
    "cap_s": 0.08,
    "fast_attempts": 2,
    "slow_interval_s": 0.15,
    "starvation_s": 0.2,
}


class SinkReactor(Reactor):
    name = "sink"
    CHAN = 0x7A

    def __init__(self):
        super().__init__()
        self.added = []
        self.removed = []

    def get_channels(self):
        return [ChannelDescriptor(self.CHAN, priority=1)]

    def add_peer(self, peer):
        self.added.append(peer.peer_id)

    def remove_peer(self, peer, reason):
        self.removed.append(peer.peer_id)


def _mem_switch(table=None, chain="reconnect-test", cls=Switch):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network=chain)
    tr = MemoryTransport(nk, info, link_hook=table)
    sw = cls(tr, info, reconnect_config=dict(FAST_RECONNECT))
    sw.add_reactor("sink", SinkReactor())
    sw.tracer = Tracer(name=nk.node_id[:8])
    sw.spans = []
    sw.tracer.add_observer(lambda name, dur, args: sw.spans.append((name, dict(args))))
    return sw


async def _mesh(switches):
    """Ring-dial (i -> i+1): with 3 switches that is the full mesh,
    and every switch owns one persistent outbound dial."""
    for sw in switches:
        await sw.transport.listen()
        await sw.start()
    n = len(switches)
    for i, a in enumerate(switches):
        b = switches[(i + 1) % n]
        await a.dial_peer(f"{b.node_info.node_id}@mem://{b.node_info.node_id}", persistent=True)
    for sw in switches:
        for _ in range(200):
            if sw.num_peers() == n - 1:
                break
            await asyncio.sleep(0.01)
        assert sw.num_peers() == n - 1


async def _wait(cond, timeout=20.0, what=""):
    for _ in range(int(timeout / 0.02)):
        if cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _kill_all_conns(sw):
    for peer in list(sw.peers.values()):
        peer.inject_error(ConnectionError("pong timeout (injected)"))


def _minority_scenario(cls):
    """Partition the minority off, kill its conns (pong-timeout style),
    let every fast lane exhaust into the slow lane, heal — the sweep
    must reconverge the full mesh."""

    async def main():
        table = LinkTable(seed=7)
        sws = [_mem_switch(table, cls=cls) for _ in range(3)]
        try:
            await _mesh(sws)
            minority = sws[2]
            others = [sws[0], sws[1]]
            table.partition([[s.node_info.node_id for s in others], [minority.node_info.node_id]])
            _kill_all_conns(minority)
            await _wait(
                lambda: minority.num_peers() == 0 and all(s.num_peers() == 1 for s in others),
                what="conn deaths to propagate",
            )
            await _wait(
                lambda: minority.reconnect.slow_parks_total >= 1 and sws[1].reconnect.slow_parks_total >= 1,
                what="fast budgets to exhaust into the slow lane",
            )
            assert minority.reconnect.slow_lane, "peers abandoned!"
            assert minority.reconnect.attempts_total >= 2
            assert minority.reconnect.flaps_total >= 2
            table.heal()
            await _wait(lambda: all(s.num_peers() == 2 for s in sws), what="slow-lane sweep to reconverge the mesh")
            plane = minority.reconnect
            assert not plane.slow_lane and not plane._fast_tasks
            for bo in plane._backoffs.values():
                assert bo.attempt == 0
            assert plane.recoveries_total >= 1
            spans = [args for name, args in minority.spans if name == "p2p.reconnect"]
            assert spans, "no p2p.reconnect span recorded"
            assert any(a.get("recovered") for a in spans), spans
        finally:
            for sw in sws:
                await sw.stop()

    run(main())


def test_healed_minority_reconverges_native_switch():
    _minority_scenario(Switch)


def test_healed_minority_reconverges_lp2p_switch():
    # parity: Lp2pSwitch inherits the same plane (shared lifecycle)
    _minority_scenario(Lp2pSwitch)


def test_boot_dial_failure_routes_to_plane():
    """A persistent dial that fails before ANY conn existed (target down
    at boot) must land on the plane — and succeed once the target
    appears."""

    async def main():
        table = LinkTable(seed=11)
        a = _mem_switch(table)
        b = _mem_switch(table)
        await a.transport.listen()
        await a.start()
        await b.transport.listen()
        table.partition([[a.node_info.node_id], [b.node_info.node_id]])
        try:
            await a.dial_peer(f"{b.node_info.node_id}@mem://{b.node_info.node_id}", persistent=True)
        except Exception:
            pass
        assert a.reconnect.is_scheduled(b.node_info.node_id)
        assert a.reconnect.dial_failures_total >= 1
        await b.start()
        table.heal()
        await _wait(lambda: a.num_peers() == 1 and b.num_peers() == 1, what="boot-failed dial to recover via the plane")
        await a.stop()
        await b.stop()

    run(main())


def test_restarted_incarnation_evicts_zombie_entry():
    """A holds a still-open conn to B's PREVIOUS life; restarted B (same
    node id, fresh incarnation) dials A: the zombie is evicted
    synchronously and the fresh conn registers."""

    async def main():
        a = _mem_switch()
        b1 = _mem_switch()
        key = b1.transport.node_key
        await _mesh([a, b1])
        bid = b1.node_info.node_id
        old_inc = a.peers[bid].node_info.incarnation
        assert old_inc  # incarnation rides the handshake

        info2 = NodeInfo(node_id=bid, network="reconnect-test")
        tr2 = MemoryTransport(key, info2)  # re-registers the mem hub
        b2 = Switch(tr2, info2, reconnect_config=dict(FAST_RECONNECT))
        b2.add_reactor("sink", SinkReactor())
        await b2.transport.listen()
        await b2.start()
        peer = await b2.dial_peer(f"{a.node_info.node_id}@mem://{a.node_info.node_id}", persistent=True)
        assert peer is not None and peer.peer_id == a.node_info.node_id
        await _wait(
            lambda: a.peers.get(bid) is not None and a.peers[bid].node_info.incarnation == info2.incarnation,
            what="fresh incarnation to replace the zombie entry",
        )
        assert a.peers[bid].node_info.incarnation != old_inc
        assert a.num_peers() == 1  # replaced, not duplicated
        await a.stop()
        await b2.stop()
        b1.abort()

    run(main())


def test_acceptor_redial_beats_long_established_zombie():
    """One-sided death at the original ACCEPTOR: its redial must not be
    dup-discarded against the dialer's zombie entry."""

    async def main():
        a = _mem_switch()
        b = _mem_switch()
        await _mesh([a, b])
        aid, bid = a.node_info.node_id, b.node_info.node_id
        old_peer = a.peers[bid]
        # age the established conn out of the cross-dial window
        old_peer.established_at -= 60.0
        # one-sided death at b: b loses its ENTRY while the fds stay open
        b.peers.pop(aid)
        await asyncio.sleep(0.05)
        await b.dial_peer(f"{aid}@mem://{aid}", persistent=True)
        await _wait(
            lambda: a.peers.get(bid) is not None and a.peers[bid] is not old_peer,
            what="redial to evict the zombie entry at a",
        )
        assert a.num_peers() == 1 and b.num_peers() == 1
        await a.stop()
        await b.stop()

    run(main())


def test_simultaneous_cross_dial_resolves_deterministically():
    """Both sides dial at once: each pair converges to exactly ONE
    conn, the one dialed by the LOWER node id on both ends."""

    async def main():
        a = _mem_switch()
        b = _mem_switch()
        for sw in (a, b):
            await sw.transport.listen()
            await sw.start()
        aid, bid = a.node_info.node_id, b.node_info.node_id
        low = min(aid, bid)
        await asyncio.gather(
            a.dial_peer(f"{bid}@mem://{bid}", persistent=True),
            b.dial_peer(f"{aid}@mem://{aid}", persistent=True),
            return_exceptions=True,
        )
        await _wait(lambda: a.num_peers() == 1 and b.num_peers() == 1, what="cross-dial to settle on one conn per side")
        await asyncio.sleep(0.3)
        assert a.num_peers() == 1 and b.num_peers() == 1
        winner_dialed_by_a = a.peers[bid].outbound
        winner_dialed_by_b = b.peers[aid].outbound
        assert winner_dialed_by_a != winner_dialed_by_b
        assert winner_dialed_by_a == (low == aid)
        await a.stop()
        await b.stop()

    run(main())


def test_starvation_triggers_pex_relearn():
    """Zero peers past the starvation threshold: the next dial success
    must fire a rate-limit-bypassing PEX request so the minority
    re-learns moved addresses immediately."""

    class PexStub(Reactor):
        name = "pex"

        def __init__(self):
            super().__init__()
            self.requested = []

        def get_channels(self):
            return []

        def request_now(self, peer):
            self.requested.append(peer.peer_id)

        def receive(self, chan_id, peer, msg):
            pass

    async def main():
        a = _mem_switch()
        b = _mem_switch()
        stub = a.add_reactor("pex", PexStub())
        for sw in (a, b):
            await sw.transport.listen()
            await sw.start()
        # a is meant to be connected (boot config names b) but has
        # zero peers past the threshold: starving
        bid = b.node_info.node_id
        a.persistent_addrs[bid] = f"mem://{bid}"
        await asyncio.sleep(0.3)
        assert a.reconnect.starving()
        # a switch with nothing to dial is not starving
        assert not b.reconnect.starving()
        await a.dial_peer(f"{bid}@mem://{bid}", persistent=True)
        assert stub.requested == [bid]
        assert not a.reconnect.starving()
        # the starvation clock accumulated the episode
        assert a.reconnect.starvation_seconds() >= 0.3
        await a.stop()
        await b.stop()

    run(main())


def test_health_connectivity_verdict():
    """rpc health: ok for a node with nothing to dial; degraded (with
    reconnect detail) once it expects peers it does not have."""
    from cometbft_tpu_torch.rpc import core
    from cometbft_tpu_torch.rpc.env import Environment

    class StubStore:
        def height(self):
            return 0

        def load_block_meta(self, h):
            return None

    async def main():
        sw = _mem_switch()
        env = Environment(block_store=StubStore(), switch=sw)
        h = core.health(env)
        # no persistent peers, empty book, no flaps: no expectation
        assert h["connectivity"]["status"] == "ok"
        assert h["status"] == "ok"
        # now the node is meant to be connected and is not
        sw.persistent_addrs["deadbeef"] = "mem://deadbeef"
        h = core.health(env)
        conn = h["connectivity"]
        assert conn["status"] == "degraded"
        assert conn["n_peers"] == 0 and conn["min_peers"] >= 1
        assert any("connectivity" in r for r in h["reasons"]), h["reasons"]
        assert h["status"] == "degraded"

    run(main())
