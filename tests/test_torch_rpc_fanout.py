"""The port's outbound fan-out plane (``rpc/fanout.py``) held to the JAX
package's (``tests/test_rpc_fanout.py``'s cases): one-pass delivery,
per-subscriber shed isolation, detach, the height-keyed commit
waiters, and the live websocket and commit paths over a single-node
chain. The hub and waiter cases run the same events through both
packages' modules and must observe the same frames (byte for byte) and
counters; the live cases run the reference's checks on a JAX node and
on a port node (``device="cpu"``)."""

import asyncio
import hashlib
import json

import pytest
import torch

from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.node.inprocess import make_genesis as jax_make_genesis
from cometbft_tpu.node.node import Node as JaxNode
from cometbft_tpu.rpc import client as jclient
from cometbft_tpu.rpc import fanout as jfanout
from cometbft_tpu.types import events as jev
from cometbft_tpu.utils import pubsub_query as jquery
from cometbft_tpu_torch.config.config import test_config as port_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import make_genesis as port_make_genesis
from cometbft_tpu_torch.node.inprocess import make_privvals
from cometbft_tpu_torch.node.node import Node as PortNode
from cometbft_tpu_torch.rpc import client as pclient
from cometbft_tpu_torch.rpc import fanout as pfanout
from cometbft_tpu_torch.types import events as pev
from cometbft_tpu_torch.utils import pubsub_query as pquery
from torch_hard_limit import hard_limit  # noqa: F401

PKGS = {
    "jax": (jfanout, jev, jquery),
    "port": (pfanout, pev, pquery),
}


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


def both(case):
    """``case(fanout, events, query)`` on each package's modules: both
    must observe the same."""
    got = run(case(*PKGS["jax"]))
    assert run(case(*PKGS["port"])) == got
    return got


class StubWS:
    """Socket stand-in: infinite-speed sink recording frames."""

    def __init__(self):
        self.frames = []

    async def send_str(self, s):
        self.frames.append(s)


class StuckWS(StubWS):
    """A subscriber whose socket never completes a send."""

    async def send_str(self, s):
        self.frames.append(s)
        await asyncio.Event().wait()


def _bus(ev):
    bus = ev.EventBus()
    bus.set_loop(asyncio.get_running_loop())
    return bus


# --- one-serialization-pass delivery ----------------------------------


def test_one_encode_per_group():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        hub = fanout.FanoutHub(bus)
        q_round, q_step = "tm.event='NewRound'", "tm.event='NewRoundStep'"
        subs_round = [hub.attach(StubWS(), q_round, query.parse(q_round), i) for i in range(40)]
        subs_step = [hub.attach(StubWS(), q_step, query.parse(q_step), 100 + i) for i in range(10)]
        for h in range(3):
            bus.publish_type(ev.EVENT_NEW_ROUND, h, height=h)
        bus.publish_type(ev.EVENT_NEW_ROUND_STEP, 9, height=9)
        await asyncio.sleep(0.2)
        assert hub.encodes == 4, hub.encodes
        assert all(len(s.ws.frames) == 3 for s in subs_round)
        assert all(len(s.ws.frames) == 1 for s in subs_step)
        b0, b7 = (json.loads(subs_round[i].ws.frames[0]) for i in (0, 7))
        assert b0["id"] == 0 and b7["id"] == 7 and b0["result"] == b7["result"]
        assert b0["result"]["query"] == q_round and b0["result"]["events"]["tm.event"] == ["NewRound"]
        assert hub.queue_stats()["dropped"] == 0
        frames = [s.ws.frames for s in subs_round + subs_step]
        await hub.close()
        return frames, hub.encodes

    both(case)


def test_slow_subscriber_shed_isolation():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        hub = fanout.FanoutHub(bus)
        qs = "tm.event='NewRound'"
        healthy = hub.attach(StubWS(), qs, query.parse(qs), 1)
        stuck = hub.attach(StuckWS(), qs, query.parse(qs), 2)
        stuck.queue._maxsize = 4
        n_events = 12
        for h in range(n_events):
            bus.publish_type(ev.EVENT_NEW_ROUND, h, height=h)
        await asyncio.sleep(0.3)
        assert len(healthy.ws.frames) == n_events and len(stuck.ws.frames) == 1
        assert stuck.queue.dropped >= 1
        assert len(stuck.ws.frames) + stuck.queue.qsize() + stuck.queue.dropped == n_events
        assert hub.queue_stats()["dropped"] == stuck.queue.dropped and hub.encodes == n_events
        out = (healthy.ws.frames, stuck.ws.frames, stuck.queue.dropped)
        await hub.close()
        return out

    both(case)


def test_detach_awaits_writer_task():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        hub = fanout.FanoutHub(bus)
        qs = "tm.event='NewRound'"
        sub = hub.attach(StuckWS(), qs, query.parse(qs), 1)
        bus.publish_type(ev.EVENT_NEW_ROUND, 1, height=1)
        await asyncio.sleep(0.1)
        task = sub.task
        assert not task.done()  # parked in the stuck send
        await hub.detach(sub)
        assert task.done() and hub.queue_stats()["subscribers"] == 0
        assert hub._drain_task is None and hub._sub is None
        return sub.ws.frames

    both(case)


# --- height-keyed commit waiters --------------------------------------


def test_commit_waiters_resolve_and_one_subscription():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        cw = fanout.CommitWaiterMap(bus)
        keys = [hashlib.sha256(bytes([i])).hexdigest() for i in range(8)]
        futs = [cw.register(k) for k in keys]
        assert len(bus._subs) == 0 and len(bus._sync_listeners) == 1
        for i, k in enumerate(keys):
            bus.publish_type(ev.EVENT_TX, {"height": 5, "index": i, "tx": bytes([i]), "result": None}, hash=k)
        got = await asyncio.wait_for(asyncio.gather(*futs), 5)
        assert [e.data["index"] for e in got] == list(range(8))
        assert cw.size() == 0 and cw.resolved == 8
        await cw.close()
        return [e.attrs for e in got]

    both(case)


def test_commit_waiter_survives_publish_burst():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        cw = fanout.CommitWaiterMap(bus)
        key = hashlib.sha256(b"the-one").hexdigest()
        fut = cw.register(key)
        for i in range(ev.SUBSCRIPTION_QUEUE_SIZE + 8):
            bus.publish_type(ev.EVENT_TX, {"height": 1, "index": i, "tx": b"x", "result": None}, hash=f"{i:064x}")
        bus.publish_type(ev.EVENT_TX, {"height": 1, "index": 9999, "tx": b"the-one", "result": None}, hash=key)
        e = await asyncio.wait_for(fut, 5)
        assert e.data["index"] == 9999 and cw.resolved == 1
        await cw.close()
        assert len(bus._sync_listeners) == 0
        return e.data["index"]

    both(case)


def test_commit_waiter_timeout_unsubscribe_race():
    async def case(fanout, ev, query):
        bus = _bus(ev)
        cw = fanout.CommitWaiterMap(bus)
        key = "ab" * 32
        fut = cw.register(key)
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(fut, 0.05)
        cw.unregister(key, fut)
        assert cw.size() == 0
        bus.publish_type(ev.EVENT_TX, {"height": 1, "index": 0, "tx": b"x", "result": None}, hash=key)
        await asyncio.sleep(0.05)
        assert cw.resolved == 0
        f1, f2 = cw.register(key), cw.register(key)
        bus.publish_type(ev.EVENT_TX, {"height": 2, "index": 0, "tx": b"x", "result": None}, hash=key)
        e1, e2 = await asyncio.wait_for(asyncio.gather(f1, f2), 5)
        assert e1.data["height"] == e2.data["height"] == 2
        await cw.close()
        return cw.resolved

    both(case)


# --- live single-node paths -------------------------------------------


async def single_node(pkg, tmp_path):
    """A one-validator node with RPC, committing, and a client of its
    own package."""
    if pkg == "jax":
        gen, pvs = jax_make_genesis(1, chain_id="fanout-chain")
        node = JaxNode(jax_test_cfg("."), gen, privval=pvs[0])
        client = jclient.HTTPClient
    else:
        gen, privs = port_make_genesis(1, chain_id="fanout-chain")
        cfg = port_test_cfg(".")
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        node = PortNode(cfg, gen, privval=make_privvals(privs, root=str(tmp_path))[0], device="cpu")
        client = pclient.HTTPClient
    await node.start()
    while node.height < 2:
        await asyncio.sleep(0.05)
    return node, client(node.rpc_server.listen_addr)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ws_subscription_through_hub_and_unsubscribe_all(pkg, tmp_path):
    async def main():
        node, cli = await single_node(pkg, tmp_path)
        sess = await cli._sess()
        ws = await sess.ws_connect(cli.base_url + "/websocket")
        q = "tm.event='NewBlock'"
        await ws.send_json({"jsonrpc": "2.0", "id": 7, "method": "subscribe", "params": {"query": q}})
        first = json.loads((await ws.receive()).data)
        assert "error" not in first
        hub = node.rpc_server.fanout
        assert hub.queue_stats()["subscribers"] == 1
        heights = []
        while len(heights) < 2:
            body = json.loads((await ws.receive()).data)
            res = body.get("result") or {}
            if res.get("query") == q:
                assert body["id"] == 7
                heights.append(int(res["data"]["value"]["block"]["header"]["height"]))
        assert heights[1] == heights[0] + 1
        stats = node.queues.get("rpc.fanout")
        assert stats is not None and stats["enqueued"] >= 2 and stats["dropped"] == 0
        await ws.send_json({"jsonrpc": "2.0", "id": 8, "method": "unsubscribe_all", "params": {}})
        deadline = asyncio.get_running_loop().time() + 5
        while hub.queue_stats()["subscribers"]:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)
        await ws.close()
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_concurrent_broadcast_tx_commit_single_subscription(pkg, tmp_path):
    async def main():
        node, cli = await single_node(pkg, tmp_path)
        bus = node.parts.event_bus
        before = len(bus._subs)
        txs = [b"fk%d=fv%d" % (i, i) for i in range(5)]
        results = await asyncio.gather(*[cli.broadcast_tx_commit(t) for t in txs])
        for r in results:
            assert r["tx_result"]["code"] == 0 and int(r["height"]) >= 1
        assert len(bus._subs) <= before + 1
        assert node.rpc_env.commit_waiters().size() == 0
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_indexer_queue_registered(pkg, tmp_path):
    async def main():
        node, cli = await single_node(pkg, tmp_path)
        await cli.broadcast_tx_commit(b"iq=1")
        stats = node.queues.get("state.index")
        assert stats is not None and stats["flushed_heights"] >= 1
        await cli.close()
        await node.stop()

    run(main())
