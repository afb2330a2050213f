"""A failed card during statesync is never a snapshot verdict (ROADMAP C3).

The state provider's light checks (the app hash of the snapshot height,
then the restored state's headers) run on the node's device at
``PRIORITY_CATCHUP``. When the card fails, the port's scheduler
resolves their tickets with a ``crypto.scheduler.DeviceRouteError``
chained to the card's error, and the light client raises it as it is.
The syncer lets it escape, as the JAX syncer lets any provider error
escape ``_sync_one``: the sync ends as the node's ``statesync_error``
(the node stops, as the JAX node does on any statesync failure), no
snapshot is banned or rejected for it and no peer banned, the pool
still lists the snapshot, no store is bootstrapped, the app restored
nothing, and the light client's trusted store and the header cache are
as they were when the check began.

The card is a stand-in with the device route pinned (floor 1) on
``device="cpu"``: once the joiner's first app-hash check starts, the
device dispatch of every catch-up ticket raises a ``RuntimeError``, a
``ValueError`` or an ``OSError``; every other ticket (the validators'
live votes and commits), and every ticket when working, is answered
lane by lane by the host's single ZIP-215 check
(``Ed25519PubKey.verify``), since the plain kernels on the CPU take
about a second a dispatch. With the card working (the control) the
same joiner restores and follows the chain.
"""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.crypto.scheduler import PRIORITY_CATCHUP, DeviceRouteError
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider
from torch_hard_limit import hard_limit  # noqa: F401

FAULTS = [None, RuntimeError("card lost"), ValueError("bad launch config"), OSError(5, "I/O error")]
FAULT_IDS = ["card_works", "RuntimeError", "ValueError", "OSError"]


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
    """The device route pinned on a stand-in card. Once ``armed`` (the
    first app-hash check), ``card["fault"]`` makes the device dispatch
    of every catch-up ticket raise it; ``seen`` keeps the light
    client's trusted heights and the header cache's size at that
    moment."""
    real = sched_mod.VerifyScheduler._dispatch_device
    real_app_hash = LightClientStateProvider.app_hash
    state = {"fault": None, "armed": False, "failed": 0, "catchup": 0, "seen": None}

    def dispatch(self, ticket, ed_idx, ed_items):
        if ticket.priority == PRIORITY_CATCHUP:
            state["catchup"] += 1
            if state["armed"] and state["fault"] is not None:
                state["failed"] += 1
                raise state["fault"]
        return real(self, ticket, ed_idx, ed_items)

    def answer(items, device=None, precomp=None):
        return _Answered([Ed25519PubKey(pk).verify(m, sig) for m, pk, sig in items])

    def app_hash(self, height):
        if not state["armed"]:
            state["armed"] = True
            state["seen"] = (sorted(self.client.store._by_height), len(self.header_cache))
        return real_app_hash(self, height)

    monkeypatch.setattr(sched_mod.VerifyScheduler, "_dispatch_device", dispatch)
    monkeypatch.setattr(ops_ed, "verify_batch_async", answer)
    monkeypatch.setattr(LightClientStateProvider, "app_hash", app_hash)
    crypto_batch.set_min_device_batch(1)
    return state


async def _until(cond, what, timeout=60.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_failed_card_ends_the_sync_without_a_verdict(card, fault):
    card["fault"] = fault
    gen, privs = make_genesis(3, chain_id="ss-card")

    async def main():
        nodes = []
        try:
            for i, pv_ in enumerate(make_privvals(privs)):
                cfg = make_test_cfg(".")
                cfg.base.moniker = f"val{i}"
                cfg.rpc.laddr = "tcp://127.0.0.1:0"
                cfg.blocksync.enable = False
                nodes.append(Node(cfg, gen, privval=pv_, device="cpu"))
            for n in nodes:
                await n.start()
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await _until(lambda: nodes[0].height >= 13, "height 13")
            cfg = make_test_cfg(".")
            cfg.base.moniker = "joiner"
            cfg.statesync.enable = True
            cfg.statesync.rpc_servers = [n.rpc_server.listen_addr for n in nodes[:2]]
            cfg.statesync.trust_height = 1
            cfg.statesync.trust_hash = bytes(nodes[0].parts.block_store.load_block(1).hash()).hex()
            cfg.statesync.discovery_time_s = 10.0
            joiner = Node(cfg, gen, device="cpu")
            nodes.append(joiner)
            await joiner.start()
            for n in nodes[:3]:
                await joiner.dial(n.listen_addr)
            if fault is None:
                target = nodes[0].height + 2
                await _until(lambda: joiner.height >= target, f"the joiner at {target}")
                assert joiner.statesync_error is None and card["armed"] and card["catchup"] > 0
                assert joiner.parts.block_store.base() > 1
                return
            await _until(lambda: joiner.statesync_error is not None, "the statesync error")
            err = joiner.statesync_error
            assert isinstance(err, DeviceRouteError), repr(err)
            assert err.__cause__ is fault
            assert card["failed"] >= 1
            syncer = joiner.statesync_reactor.syncer
            # no verdict on the snapshot or its senders
            assert syncer.banned_snapshots == set() and syncer.banned_peers == set()
            # still advertised, not rejected (the node's stop may have
            # dropped its peers)
            assert len(syncer.pool.snapshots) >= 1
            # nothing bootstrapped, nothing restored
            assert joiner.parts.block_store.height() == 0 and joiner.parts.block_store.base() == 0
            assert joiner.parts.state_store.load().last_block_height == 0
            assert joiner.parts.app.height == 0 and joiner.parts.app.state == {}
            # the trusted store and the header cache as the check found them
            provider = joiner.statesync_provider
            assert (sorted(provider.client.store._by_height), len(provider.header_cache)) == card["seen"]
            assert not joiner._cs_started
        finally:
            for n in nodes:
                await n.stop()

    asyncio.run(asyncio.wait_for(main(), 180))
