"""The port's serving fleet (``fleet/``: follower replicas, the session
router, consistency tokens, lag-aware shedding, lossless failover)
held to the JAX package's: every case of ``tests/test_fleet.py`` (16).

Each case is written once over a namespace of one package's classes
and runs on both, on byte-identical seeded chains; what a case returns
(every sink's frames, placement, shed and failover counters, the
routed light blocks' hashes) must be equal across the packages. The
reference's assertions hold on each: frames byte-identical to the
validator-side hub envelope, least-loaded placement, bounded
admission, tokens that route away from a lagging replica, wait its
barrier or refuse, lag shedding that degrades only the victim's
clients, a replica kill that every stranded session survives with
zero lost commits (and an honest shed without a store), the
``NodeReplica`` adapter over a node's hub, the serving plane's bounded
and reversible drain, and single flight across replicas sharing one
``VerifiedHeaderCache``. The port's light planes verify on
``device="cpu"``; the JAX package's on its "cpu" backend.
"""

import asyncio
import dataclasses
import functools
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu import fleet as jfleet
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.fleet import follower as jfollower
from cometbft_tpu.fleet import router as jrouter
from cometbft_tpu.light import client as jclient
from cometbft_tpu.light import provider as jprovider
from cometbft_tpu.light import serving as jserving
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu.rpc import fanout as jfanout
from cometbft_tpu.types import events as jev
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import pubsub_query as jquery
from cometbft_tpu_torch import fleet as pfleet
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.fleet import follower as pfollower
from cometbft_tpu_torch.fleet import router as prouter
from cometbft_tpu_torch.light import client as pclient
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import serving as pserving
from cometbft_tpu_torch.light.types import LightBlock as PLightBlock
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.rpc import fanout as pfanout
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import events as pev
from cometbft_tpu_torch.utils import chaingen as pchaingen
from cometbft_tpu_torch.utils import pubsub_query as pquery
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
Q_BLOCK = "tm.event='NewBlock'"
Q_TX = "tm.event='Tx'"
N_VALS = 2
CHAIN_LEN = 8

PORT = SimpleNamespace(
    name="port", fleet=pfleet, follower=pfollower, router=prouter, B=pblock, ev=pev,
    parse=pquery.parse, FanoutHub=pfanout.FanoutHub, event_attrs=pfanout._event_attrs,
    serving=pserving, LightBlock=PLightBlock, on_device={"device": CPU},
    Client=functools.partial(pclient.Client, device=CPU), TrustOptions=pclient.TrustOptions,
    StoreBackedProvider=pprovider.StoreBackedProvider,
)
JAX = SimpleNamespace(
    name="jax", fleet=jfleet, follower=jfollower, router=jrouter, B=JT, ev=jev,
    parse=jquery.parse, FanoutHub=jfanout.FanoutHub, event_attrs=jfanout._event_attrs,
    serving=jserving, LightBlock=JLightBlock, on_device={},
    Client=jclient.Client, TrustOptions=jclient.TrustOptions,
    StoreBackedProvider=jprovider.StoreBackedProvider,
)


@pytest.fixture(autouse=True)
def backends():
    """The port on a two-worker host plane, the JAX package on its cpu
    backend; both restored after each test."""
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    old = jbatch._default_backend
    jbatch.set_default_backend("cpu")
    yield
    jbatch.set_default_backend(old)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(case, *args):
    """Run ``case(P, *args)`` on each package and require equal
    returns."""
    got = {P.name: case(P, *args) for P in (JAX, PORT)}
    assert got["port"] == got["jax"]
    return got["port"]


class StubWS:
    def __init__(self):
        self.frames = []

    async def send_str(self, s):
        self.frames.append(s)

    def heights(self):
        return [int(prouter._HEIGHT_RE.search(f).group(1)) for f in self.frames]


class FailingWS(StubWS):
    async def send_str(self, s):
        raise RuntimeError("socket died")


def make_blocks(P, n, txs=1):
    B = P.B
    out = []
    prev = B.BlockID()
    for h in range(1, n + 1):
        data = B.Data(txs=[b"fleet/%d_%d=v" % (h, i) for i in range(txs)])
        last_commit = B.Commit(h - 1, 0, prev, []) if h > 1 else None
        header = B.Header(
            chain_id="fleet-chain", height=h, time_ns=h * 1_000_000_000, last_block_id=prev,
            app_hash=b"\x03" * 32, data_hash=data.hash(),
            last_commit_hash=last_commit.hash() if last_commit else b"",
        )
        blk = B.Block(header=header, data=data, last_commit=last_commit)
        prev = B.BlockID(blk.hash(), B.PartSetHeader(1, blk.hash()))
        out.append(blk)
    return out


async def wait_until(pred, timeout=10.0, poll=0.01, what="condition"):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(poll)


async def _fleet(P, n=2, **router_kw):
    source = P.fleet.StreamSource()
    replicas = [P.fleet.FollowerNode(f"r{i}", source, poll_s=0.01) for i in range(n)]
    router_kw.setdefault("lag_poll_s", 0.02)
    router = P.fleet.SessionRouter(replicas, store_source=source, **router_kw)
    for r in replicas:
        await r.start()
    await router.start()
    return source, replicas, router


async def _teardown(router, replicas):
    await router.close()
    for r in replicas:
        await r.stop()


def _replica_of(router, sess):
    return router._sessions.get(sess)


# --- follower tail + frame parity -------------------------------------


def test_follower_frames_match_hub_envelope():
    """Routed frames are byte-identical to what a FanoutHub would send
    (same prefix, same payload key order), and to the JAX package's."""

    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 1)
            ws = StubWS()
            sess = await router.subscribe(ws, Q_BLOCK, sub_id=7)
            blocks = make_blocks(P, 3)
            for b in blocks:
                source.advance(b)
            await wait_until(lambda: len(ws.frames) == 3, what="frames")
            prefix = '{"jsonrpc": "2.0", "id": 7, "result": '
            for blk, frame in zip(blocks, ws.frames):
                e = P.follower.height_events(blk)[0]
                assert frame == prefix + P.follower.event_payload(e, Q_BLOCK) + "}"
            assert sess.last_delivered == 3
            assert replicas[0].served_height() == 3
            assert replicas[0].lag_heights() == 0
            await _teardown(router, replicas)
            return ws.frames

        return run(main())

    assert len(both(case)) == 3


@pytest.fixture(scope="module")
def chains():
    """One genesis and its keys, an 8-block chain built by each package
    (byte-identical)."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(N_VALS, chain_id="fleet-light", seed=19,
                                  genesis_time_ns=time.time_ns() - 3_600_000_000_000)
        jgen = JGenesisDoc.from_json(gen.to_json())
        jprivs = [JPriv.from_seed(p.seed) for p in privs]
        out = {"port": (gen, pchaingen.make_chain(gen, privs, CHAIN_LEN, device=CPU)),
               "jax": (jgen, jchaingen.make_chain(jgen, jprivs, CHAIN_LEN))}
        yield out
        for _, node in out.values():
            node.close_stores()
    finally:
        pv.set_engine(None)
        eng.close()


def test_store_source_tail_from_genesis(chains):
    """A follower over a real block store replays the whole chain when
    pinned to from_height=0: frames equal across the packages."""

    def case(P):
        gen, node = chains[P.name]

        async def main():
            source = P.fleet.StoreSource(node.block_store)
            assert source.height() == CHAIN_LEN
            follower = P.fleet.FollowerNode("r0", source, poll_s=0.01)
            router = P.fleet.SessionRouter([follower], store_source=source)
            await follower.start(from_height=0)
            await router.start()
            ws = StubWS()
            await router.subscribe(ws, Q_BLOCK)
            await wait_until(lambda: len(ws.frames) == CHAIN_LEN, what="store tail")
            assert ws.heights() == list(range(1, CHAIN_LEN + 1))
            await _teardown(router, [follower])
            return ws.frames

        return run(main())

    both(case)


def test_mid_height_attach_is_a_clean_boundary():
    """A member attached while a height is being delivered receives
    NOTHING for that height: its first live height is a clean
    boundary."""

    def case(P):
        async def main():
            fan = P.fleet.ReplicaFanout()
            q = P.parse(Q_BLOCK)
            m2 = P.fleet.RoutedSession(StubWS(), Q_BLOCK, q, 2)
            attached = [False]

            class AttachingWS(StubWS):
                async def send_str(self, s):
                    await super().send_str(s)
                    if not attached[0]:
                        attached[0] = True
                        fan.attach(m2)

            m1 = P.fleet.RoutedSession(AttachingWS(), Q_BLOCK, q, 1)
            blocks = make_blocks(P, 2)
            fan.attach(m1)
            await fan.deliver(P.follower.height_events(blocks[0]), 1)
            assert attached[0]
            assert len(m1.sink.frames) == 1 and m1.last_delivered == 1
            assert m2.sink.frames == [] and m2.last_delivered == 0
            await fan.deliver(P.follower.height_events(blocks[1]), 2)
            assert m2.sink.heights() == [2] and m2.last_delivered == 2
            assert m1.sink.heights() == [1, 2]
            return m1.sink.frames, m2.sink.frames, fan.stats()

        return run(main())

    both(case)


# --- admission + placement --------------------------------------------


def test_least_loaded_placement():
    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 3)
            for i in range(9):
                await router.subscribe(StubWS(), Q_BLOCK, sub_id=i)
            members = [r.members() for r in replicas]
            await _teardown(router, replicas)
            return members

        return run(main())

    assert both(case) == [3, 3, 3]


def test_admission_bound_sheds_and_releases():
    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 1, max_sessions=2)
            s1 = await router.subscribe(StubWS(), Q_BLOCK)
            await router.subscribe(StubWS(), Q_BLOCK)
            with pytest.raises(P.fleet.FleetOverloadError):
                await router.subscribe(StubWS(), Q_BLOCK)
            assert router.gate.stats()["dropped"] == 1
            assert router.fleet_status()["sheds"]["admit"] == 1
            # a departing session frees its admission slot
            await router.unsubscribe(s1)
            await router.subscribe(StubWS(), Q_BLOCK)
            stats = router.gate.stats()
            await _teardown(router, replicas)
            return stats

        return run(main())

    both(case)


def test_failed_sink_degrades_only_its_session():
    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 1)
            bad = await router.subscribe(FailingWS(), Q_BLOCK)
            good_ws = StubWS()
            await router.subscribe(good_ws, Q_BLOCK)
            source.advance(make_blocks(P, 1)[0])
            await wait_until(lambda: bad.closed and bad not in router._sessions, what="failed-sink reap")
            assert bad.close_reason == "send_failed"
            assert len(good_ws.frames) == 1
            assert router.gate.stats()["depth"] == 1
            out = bad.close_reason, good_ws.frames, replicas[0].fanout.stats()
            await _teardown(router, replicas)
            return out

        return run(main())

    both(case)


# --- consistency tokens -----------------------------------------------


def test_token_routes_away_from_lagging_replica():
    """A request carrying token H lands only on a replica whose served
    height >= H: the lagging replica never sees it."""

    def case(P):
        async def main():
            source, (r0, r1), router = await _fleet(P, 2, max_lag_heights=100)
            blocks = make_blocks(P, 8)
            for b in blocks[:5]:
                source.advance(b)
            await wait_until(lambda: r0.served_height() == 5 and r1.served_height() == 5, what="both at 5")
            r0.stalled = True
            for b in blocks[5:]:
                source.advance(b)
            await wait_until(lambda: r1.served_height() == 8, what="r1 at 8")
            token = router.issue_token()
            assert token == 8
            for i in range(10):
                await router.subscribe(StubWS(), Q_BLOCK, sub_id=i, token=token)
            assert r0.members() == 0 and r1.members() == 10
            assert (await router.route_read(token)) is r1
            out = token, r0.members(), r1.members()
            await _teardown(router, [r0, r1])
            return out

        return run(main())

    assert both(case) == (8, 0, 10)


def test_token_waits_barrier_then_serves():
    """Nobody satisfies the token yet: the router parks on the most
    advanced replica's height barrier and resolves as soon as the tail
    catches up; it never serves below the token."""

    def case(P):
        async def main():
            source, (r0,), router = await _fleet(P, 1, max_lag_heights=100, token_wait_s=5.0)
            blocks = make_blocks(P, 5)
            for b in blocks[:3]:
                source.advance(b)
            await wait_until(lambda: r0.served_height() == 3, what="r0 at 3")
            r0.stalled = True
            for b in blocks[3:]:
                source.advance(b)
            token = router.issue_token()
            assert token == 5
            read = asyncio.ensure_future(router.route_read(token))
            await asyncio.sleep(0.1)
            assert not read.done()  # parked on the barrier, not stale
            r0.stalled = False
            assert (await read) is r0
            assert r0.served_height() >= 5
            await _teardown(router, [r0])
            return token

        return run(main())

    both(case)


def test_token_unsatisfiable_raises_stale_read():
    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 2, max_lag_heights=100, token_wait_s=0.2)
            blocks = make_blocks(P, 4)
            for b in blocks[:2]:
                source.advance(b)
            await wait_until(lambda: all(r.served_height() == 2 for r in replicas), what="both at 2")
            for r in replicas:
                r.stalled = True
            source.advance(blocks[3])
            token = router.issue_token()
            assert token == 4
            with pytest.raises(P.fleet.StaleReadError):
                await router.route_read(token)
            with pytest.raises(P.fleet.StaleReadError):
                await router.subscribe(StubWS(), Q_BLOCK, token=token)
            # the refused subscribe released its admission slot
            assert router.gate.stats()["depth"] == 0
            stats = router.gate.stats()
            await _teardown(router, replicas)
            return stats

        return run(main())

    both(case)


# --- lag-aware shedding -----------------------------------------------


def test_lag_shed_isolates_victims_clients():
    """A replica stalled past max_lag_heights is drained and its
    sessions shed; bystanders on healthy replicas lose NOTHING. After
    the victim catches back up it rotates back into placement."""

    def case(P):
        async def main():
            source, (r0, r1), router = await _fleet(P, 2, max_lag_heights=2, lag_poll_s=0.02)
            s_a = await router.subscribe(StubWS(), Q_BLOCK, sub_id=0)
            s_b = await router.subscribe(StubWS(), Q_BLOCK, sub_id=1)
            victim_sess, bystander_sess = (s_a, s_b) if _replica_of(router, s_a) is r0 else (s_b, s_a)
            blocks = make_blocks(P, 6)
            source.advance(blocks[0])
            await wait_until(lambda: r0.served_height() == 1 and r1.served_height() == 1, what="both at 1")
            r0.stalled = True
            for b in blocks[1:]:
                source.advance(b)
            await wait_until(lambda: victim_sess.closed, what="lag shed")
            assert victim_sess.close_reason == "shed_lag"
            st = router.fleet_status()
            assert st["sheds"]["lag"] == 1
            assert [r["degraded"] for r in st["replicas"]] == [True, False]
            await wait_until(lambda: len(bystander_sess.sink.frames) == 6, what="bystander stream")
            assert bystander_sess.sink.heights() == list(range(1, 7))
            assert not bystander_sess.closed
            # new placements avoid the degraded replica
            await router.subscribe(StubWS(), Q_BLOCK, sub_id=9)
            assert r0.members() == 0
            r0.stalled = False
            await wait_until(lambda: not router.fleet_status()["replicas"][0]["degraded"], what="recovery")
            out = victim_sess.close_reason, st["sheds"], bystander_sess.sink.frames
            await _teardown(router, [r0, r1])
            return out

        return run(main())

    both(case)


# --- failover ---------------------------------------------------------


def test_failover_zero_lost_commits():
    """Replica death mid-stream: every stranded session is re-admitted
    on a survivor and its delivered stream is gap-free AND
    byte-identical to an uninterrupted one (store replay + splice)."""

    def case(P):
        async def main():
            source, (r0, r1), router = await _fleet(P, 2)
            sessions = []
            for i in range(4):
                q = Q_BLOCK if i % 2 == 0 else Q_TX
                sessions.append(await router.subscribe(StubWS(), q, sub_id=i))
            stranded = [s for s in sessions if _replica_of(router, s) is r0]
            assert len(stranded) == 2
            blocks = make_blocks(P, 8, txs=2)
            for b in blocks[:4]:
                source.advance(b)
            await wait_until(lambda: r0.served_height() == 4 and r1.served_height() == 4, what="both at 4")
            await r0.kill()
            for b in blocks[4:]:
                source.advance(b)
            await wait_until(lambda: all(_replica_of(router, s) is r1 for s in stranded), what="failover")
            st = router.fleet_status()
            assert st["failovers"] == 1
            assert st["sessions_resumed"] == 2
            assert st["sheds"]["failover"] == 0
            exp_block = list(range(1, 9))
            exp_tx = [h for h in range(1, 9) for _ in range(2)]
            for s in sessions:
                want = exp_block if s.query_str == Q_BLOCK else exp_tx
                await wait_until(lambda s=s, want=want: len(s.sink.frames) == len(want),
                                 what=f"full stream for {s.sub_id}")
                assert s.sink.heights() == want, s.sub_id
            for s in stranded:
                assert s.resumes == 1
                expect = [s._prefix + P.follower.event_payload(e, s.query_str) + "}"
                          for blk in blocks for e in P.follower.height_events(blk)
                          if s.query.matches(P.event_attrs(e))]
                assert s.sink.frames == expect
            out = [s.sink.frames for s in sessions], st["failovers"], st["sessions_resumed"], st["sheds"]
            await _teardown(router, [r0, r1])
            return out

        return run(main())

    both(case)


def test_failover_without_store_sheds_honestly():
    """No store to replay from: a live-only re-admit would be lossy, so
    the router sheds instead of silently dropping commits."""

    def case(P):
        async def main():
            source = P.fleet.StreamSource()
            replicas = [P.fleet.FollowerNode(f"r{i}", source, poll_s=0.01) for i in range(2)]
            router = P.fleet.SessionRouter(replicas, store_source=None, lag_poll_s=0.02)
            for r in replicas:
                await r.start()
            await router.start()
            ws = StubWS()
            sess = await router.subscribe(ws, Q_BLOCK)
            victim = _replica_of(router, sess)
            for b in make_blocks(P, 2):
                source.advance(b)
            await wait_until(lambda: victim.served_height() == 2, what="victim at 2")
            await victim.kill()
            await wait_until(lambda: sess.closed, what="failover shed")
            assert sess.close_reason == "failover_shed"
            st = router.fleet_status()
            assert st["sheds"]["failover"] == 1
            assert st["sessions_resumed"] == 0
            out = sess.close_reason, st["sheds"], ws.frames
            await _teardown(router, replicas)
            return out

        return run(main())

    both(case)


# --- NodeReplica adapter ----------------------------------------------


def test_node_replica_adapter_surface():
    import types as _types

    def case(P):
        async def main():
            bus = P.ev.EventBus()
            bus.set_loop(asyncio.get_running_loop())
            hub = P.FanoutHub(bus)
            node = _types.SimpleNamespace(
                parts=_types.SimpleNamespace(privval=None),
                rpc_server=_types.SimpleNamespace(fanout=hub),
                height=5,
                config=_types.SimpleNamespace(base=_types.SimpleNamespace(moniker="adapter")),
            )
            rep = P.fleet.NodeReplica(node)
            assert rep.role == "follower"
            node.parts.privval = object()
            assert rep.role == "validator"
            assert rep.served_height() == 5 and rep.lag_heights() == 0
            assert await rep.wait_height(4, 0.1)
            assert not await rep.wait_height(9, 0.05)
            sess = P.fleet.RoutedSession(StubWS(), Q_BLOCK, P.parse(Q_BLOCK), 1)
            sess.parse_heights = rep.HUB_DELIVERY
            rep.attach(sess)
            assert rep.members() == 1
            blk = make_blocks(P, 1)[0]
            bus.publish(P.ev.Event(P.ev.EVENT_NEW_BLOCK,
                                   {"block": blk, "block_id": None, "result_events": []}, {"height": "1"}))
            await wait_until(lambda: len(sess.sink.frames) == 1, what="hub frame")
            assert sess.last_delivered == 1  # parsed, no on_height signal
            await rep.detach_member(sess)
            assert rep.members() == 0
            await hub.close()
            return sess.sink.frames, rep.status()

        return run(main())

    both(case)


# --- fleet status -----------------------------------------------------


def test_fleet_status_shape():
    def case(P):
        async def main():
            source, replicas, router = await _fleet(P, 2)
            await router.subscribe(StubWS(), Q_BLOCK)
            router.issue_token()
            st = router.fleet_status()
            assert st["sessions"] == 1
            assert st["tokens_issued"] == 1
            assert set(st["sheds"]) == {"admit", "lag", "failover"}
            assert st["admission"]["maxsize"] == 4096
            assert len(st["replicas"]) == 2
            for rs in st["replicas"]:
                assert rs["role"] == "follower"
                assert rs["alive"] and not rs["degraded"]
                assert rs["lag_heights"] == 0
            assert json.dumps(st)  # JSON-serializable for /fleet_status
            await _teardown(router, replicas)
            return st

        return run(main())

    both(case)


# --- the serving plane's drain + a cache shared across replicas -------


def _light_client(P, gen, node):
    provider = P.StoreBackedProvider(gen.chain_id, node.block_store, node.state_store)
    root = provider.light_block(1)
    return P.Client(gen.chain_id, P.TrustOptions(period_ns=24 * 3600 * 10**9, height=1, hash=root.hash()),
                    provider)


def test_plane_drain_is_bounded_and_reversible(chains):
    def case(P):
        gen, node = chains[P.name]
        plane = P.serving.LightServingPlane([_light_client(P, gen, node)], **P.on_device)
        served = [plane.serve(5).hash()]
        # a held in-flight slot: drain must time out BOUNDED, not hang
        assert plane.gate.enter(1.0)
        t0 = time.monotonic()
        assert plane.drain(timeout_s=0.3) is False
        assert 0.25 <= time.monotonic() - t0 < 2.0
        assert plane.stats()["draining"]
        # draining sheds new work with the standard overload error
        with pytest.raises(P.serving.ServingOverloadError):
            plane.serve(6)
        with pytest.raises(P.serving.ServingOverloadError):
            plane.open_session()
        shed = plane.requests_shed
        assert shed >= 1
        plane.gate.exit()
        assert plane.drain(timeout_s=1.0) is True
        plane.resume()
        assert not plane.stats()["draining"]
        served.append(plane.serve(5).hash())  # cache hit, serving again
        return served, shed

    both(case)


def test_cross_replica_shared_cache_single_flight(chains):
    """Two followers, one VerifiedHeaderCache: a height requested
    through BOTH replicas' planes concurrently verifies exactly once
    process-wide, and the poison refusal is unchanged."""

    def case(P):
        gen, node = chains[P.name]
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        planes = [P.serving.LightServingPlane([_light_client(P, gen, node)], cache=cache, **P.on_device)
                  for _ in range(2)]

        async def main():
            source = P.fleet.StoreSource(node.block_store)
            followers = [P.fleet.FollowerNode(f"r{i}", source, light_plane=planes[i], poll_s=0.01)
                         for i in range(2)]
            router = P.fleet.SessionRouter(followers, store_source=source)
            for f in followers:
                await f.start()
            await router.start()
            verify_calls = []
            for p in planes:
                orig = p._verify

                def counted(h, _orig=orig):
                    verify_calls.append(h)
                    time.sleep(0.05)  # hold the flight so peers pile up
                    return _orig(h)

                p._verify = counted
            got = []
            threads = [threading.Thread(target=lambda: got.append(router.serve_light(6, None)))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                await asyncio.to_thread(t.join)
            assert len(got) == 4
            assert len(verify_calls) == 1, verify_calls
            assert all(lb.height == 6 for lb in got)
            assert cache.hits + cache.flight_waits >= 3
            before = len(verify_calls)
            assert planes[1].serve(6).height == 6
            assert len(verify_calls) == before
            lb = got[0]
            poisoned = P.LightBlock(header=dataclasses.replace(lb.header, app_hash=b"\x66" * 32),
                                    commit=lb.commit, validator_set=lb.validator_set)
            entries_before = len(cache)
            with pytest.raises(P.serving.CachePoisonError):
                cache.publish(poisoned)
            assert len(cache) == entries_before
            await _teardown(router, followers)
            return [lb.hash() for lb in got], verify_calls

        return run(main())

    both(case)
