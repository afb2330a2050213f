"""The port's BlockPool ban lifecycle, the JAX package's cases: expiry
re-admits a peer, a mid-request ban reroutes the height to another
peer, bans survive peer churn, expired bans are pruned, soft
exclusions steer the starvation guard, and an all-banned pool never
starves (the liveness guard in _pick_peer)."""

import asyncio

import pytest

from cometbft_tpu_torch.blocksync import pool as pool_mod
from cometbft_tpu_torch.blocksync.pool import BlockPool
from torch_hard_limit import hard_limit  # noqa: F401


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(pool_mod, "_now", c.monotonic)
    return c


class StubClient:
    """request_block resolves instantly, or hangs when told to."""

    def __init__(self, name, hang=False):
        self.name = name
        self.hang = hang
        self.requests = []

    async def request_block(self, height):
        self.requests.append(height)
        if self.hang:
            await asyncio.Event().wait()  # never resolves
        return ("block", self.name, height)


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _mk_pool(clock, *clients, height=20):
    p = BlockPool(1)
    # no event loop in the sync pick-logic tests: inhibit requester
    # task spawning (set_peer_range/redo_request would create_task)
    p._stopped = True
    for c in clients:
        p.peers[c.name] = pool_mod.PoolPeer(
            c.name, c, base=1, height=height
        )
    return p


def test_ban_expiry_readmits_peer(clock):
    a, b = StubClient("a"), StubClient("b")
    p = _mk_pool(clock, a, b)
    p.ban_peer("a")
    assert p.banned_peers() == ["a"]
    # while banned, b is always picked
    for _ in range(10):
        assert p._pick_peer(1).peer_id == "b"
    # after expiry the ban lapses and a competes again
    clock.now += pool_mod.BAN_DURATION_S + 1
    assert p.banned_peers() == []
    picked = {p._pick_peer(1).peer_id for _ in range(50)}
    assert "a" in picked


def test_bans_survive_peer_churn(clock):
    a, b = StubClient("a"), StubClient("b")
    p = _mk_pool(clock, a, b)
    p.ban_peer("a", "bad block")
    # the banned peer disconnects and re-dials (churn): the ban must
    # NOT be laundered by the reconnect
    p.remove_peer("a")
    p.set_peer_range("a", a, 1, 20)
    assert "a" in p.banned_peers()
    for _ in range(10):
        assert p._pick_peer(1).peer_id == "b"


def test_all_banned_pool_does_not_starve(clock):
    a, b = StubClient("a"), StubClient("b")
    p = _mk_pool(clock, a, b)
    p.ban_peer("a")
    clock.now += 10.0
    p.ban_peer("b")
    # liveness guard: least-recently-banned peer still serves
    got = p._pick_peer(1)
    assert got is not None and got.peer_id == "a"
    # a height nobody serves is still None
    assert p._pick_peer(999) is None


def test_starvation_guard_still_respects_soft_exclusions(clock):
    """All peers banned AND one soft-excluded for the height: the
    guard must prefer the banned-but-capable peer over the one known
    to be structurally unable to serve it."""
    a, b = StubClient("a"), StubClient("b")
    p = _mk_pool(clock, a, b)
    p.ban_peer("a")
    clock.now += 10.0
    p.ban_peer("b")
    # 'a' would win on ban recency, but it is excluded for height 5
    p.exclude_peer_for_height(5, "a")
    assert p._pick_peer(5).peer_id == "b"
    # other heights keep the recency order
    assert p._pick_peer(6).peer_id == "a"
    # everyone excluded: exclusion yields (never a liveness risk)
    p.exclude_peer_for_height(5, "b")
    assert p._pick_peer(5) is not None


def test_expired_bans_are_pruned_not_just_ignored(clock):
    """Peer churn over a long sync must not grow banned_until
    unboundedly: expired entries are deleted on the next scan."""
    a = StubClient("a")
    p = _mk_pool(clock, a)
    for i in range(50):
        p.ban_peer(f"ghost-{i}")
    assert len(p.banned_until) == 50
    clock.now += pool_mod.BAN_DURATION_S + 1
    p.ban_peer("a")
    assert p.banned_peers() == ["a"]
    assert len(p.banned_until) == 1  # the 50 ghosts were pruned


def test_ban_mid_request_reroutes_height(monkeypatch):
    """A peer banned while its request is in flight: redo_request drops
    its buffered blocks and the refetch lands on the other peer."""
    # keep the in-flight request's own timeout short so the hung
    # requester re-picks (now rerouted away from the banned peer) fast
    monkeypatch.setattr(pool_mod, "REQUEST_TIMEOUT_S", 0.3)

    async def main():
        slow = StubClient("slow", hang=True)
        fast = StubClient("fast")
        p = BlockPool(1)
        p.set_peer_range("slow", slow, 1, 5)
        # 'slow' is the only peer: every requester hangs in flight on it
        await asyncio.sleep(0.1)
        assert set(slow.requests) == {1, 2, 3, 4, 5}
        assert 1 in p._tasks and not p.blocks

        # a second peer appears; buffered blocks from 'slow' at later
        # heights simulate earlier deliveries
        p.set_peer_range("fast", fast, 1, 5)
        p.blocks[3] = (("block", "slow", 3), "slow")

        # mid-request ban + reroute (the reactor's bad-block path)
        p.redo_request(1, ban_peer="slow")
        assert "slow" in p.banned_peers()
        assert 3 not in p.blocks  # buffered blocks from the peer dropped

        async def fetched():
            while 1 not in p.blocks:
                await asyncio.sleep(0.01)

        await asyncio.wait_for(fetched(), 10)
        blk, peer_id = p.blocks[1]
        assert peer_id == "fast" and blk == ("block", "fast", 1)
        # height 3 was respawned and also rerouted to 'fast'
        await asyncio.sleep(0.1)
        assert 3 in fast.requests or 3 in p.blocks
        p.stop()

    run(main())


def test_redo_request_keeps_other_peers_blocks(clock):
    a, b = StubClient("a"), StubClient("b")
    p = _mk_pool(clock, a, b, height=10)
    p.blocks[2] = (("block", "a", 2), "a")
    p.blocks[3] = (("block", "b", 3), "b")
    p.redo_request(2, ban_peer="a")
    assert 3 in p.blocks  # the innocent peer's block survives
    assert 2 not in p.blocks
