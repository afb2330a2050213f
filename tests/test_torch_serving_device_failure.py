"""A failed device route on the light serving path is no verdict
(ROADMAP C3, "on the serving path").

A stand-in card: the device route pinned (floor 1) on ``device="cpu"``,
its dispatch answering with host verification, or raising what the
device route can raise: a CUDA error (``RuntimeError``), a kernel's
shape check (``ValueError``) or a kernel library that does not load
(``OSError``). The scheduler resolves such a ticket with a
``DeviceRouteError`` chained to that error. On the serving plane:

- every job of a coalesced batch gets that one ``DeviceRouteError``,
  and every single-flight follower its leader's, unchanged;
- the shared cache publishes nothing and records no commit verdict;
- the verifier client's trusted store stays as it was;
- the proxy answers JSON-RPC ``-32603`` naming the failed route, not
  a verification failure, and keeps serving.

With the card back, the same requests verify, and the verdicts and
blocks equal a serial client's.
"""

import asyncio
import dataclasses
import threading
from fractions import Fraction

import aiohttp
import pytest
import torch

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.light import Client, StoreBackedProvider, TrustOptions
from cometbft_tpu_torch.light.proxy import LightProxy
from cometbft_tpu_torch.light.serving import (
    CoalescedCommitVerifier,
    LightServingPlane,
    VerifiedHeaderCache,
)
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.types import validation as V
from cometbft_tpu_torch.utils.chaingen import make_chain
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
FAULTS = [RuntimeError("CUDA error: launch failed"), ValueError("ladder: rows 16 apart expected"),
          OSError("libladder.so: cannot open shared object file")]
FAULT_IDS = ["RuntimeError", "ValueError", "OSError"]
TARGET = 12


class _Answered:
    """A device handle that is already resolved."""

    def __init__(self, oks):
        self.oks = oks
        self.dispatch = {}

    def wait(self):
        pass

    def result(self):
        return self.oks


@pytest.fixture(autouse=True)
def pinned_device_route():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    old_floor = crypto_batch._MIN_DEVICE_BATCH
    crypto_batch.set_min_device_batch(1)
    yield
    crypto_batch.set_min_device_batch(old_floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture
def card(monkeypatch):
    """``card["fault"] = <exception>`` makes every device dispatch raise
    it; None answers each lane with host verification."""
    state = {"fault": None, "failed": 0}

    def dispatch(items, device=None, precomp=None):
        if state["fault"] is not None:
            state["failed"] += 1
            raise state["fault"]
        return _Answered([Ed25519PubKey(pk).verify(m, sig) for m, pk, sig in items])

    monkeypatch.setattr(ops_ed, "verify_batch_async", dispatch)
    return state


@pytest.fixture(scope="module")
def chain():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id="c3-serving", seed=17)
        return gen, make_chain(gen, privs, 16, device=CPU)
    finally:
        pv.set_engine(None)
        eng.close()


def _client(gen, node):
    provider = StoreBackedProvider(gen.chain_id, node.block_store, node.state_store)
    return Client(gen.chain_id, TrustOptions(10**18, 1, provider.light_block(1).hash()), provider, device=CPU)


def _jobs(gen, node):
    lb = StoreBackedProvider(gen.chain_id, node.block_store, node.state_store).light_block(TARGET)
    sig0 = dataclasses.replace(lb.commit.signatures[0], signature=bytes(64))
    forged = dataclasses.replace(lb.commit, signatures=[sig0] + list(lb.commit.signatures[1:]))
    return [("light", lb.validator_set, lb.commit.block_id, lb.height, lb.commit),
            ("light", lb.validator_set, lb.commit.block_id, lb.height, forged),
            ("trusting", lb.validator_set, lb.commit, Fraction(1, 3)),
            ("trusting", lb.validator_set, forged, Fraction(1, 3))]


def _submit_all(engine, jobs):
    """Each job from its own thread, so they share one batch; returns
    the error (or None) of each."""
    got = [None] * len(jobs)

    def submit(i, job):
        try:
            if job[0] == "light":
                engine.verify_commit_light(*job[1:])
            else:
                engine.verify_commit_light_trusting(*job[1:])
        except Exception as e:  # the outcome under test, whatever its type
            got[i] = e

    threads = [threading.Thread(target=submit, args=(i, j)) for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got


def _serial(gen, jobs):
    out = []
    for job in jobs:
        try:
            if job[0] == "light":
                V.verify_commit_light(gen.chain_id, *job[1:], device=CPU)
            else:
                V.verify_commit_light_trusting(gen.chain_id, job[1], job[2], trust_level=job[3], device=CPU)
            out.append(None)
        except V.CommitVerifyError as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_every_job_of_a_failed_batch_gets_the_route_error(chain, card, fault):
    gen, node = chain
    jobs = _jobs(gen, node)
    cache = VerifiedHeaderCache(gen.chain_id)
    engine = CoalescedCommitVerifier(gen.chain_id, verdict_cache=cache, window_s=0.25, device=CPU)
    card["fault"] = fault
    got = _submit_all(engine, jobs)
    assert all(isinstance(e, DeviceRouteError) for e in got), got
    assert all(e is got[0] for e in got)  # one error, unchanged, for every job
    assert isinstance(got[0].__cause__, type(fault)) and card["failed"] >= 1
    assert engine.dispatches == 1 and engine.max_batch_seen == len(jobs)
    assert cache.stats()["verdicts"] == 0 and len(cache) == 0
    # the card back: the same batch, the serial verdicts
    card["fault"] = None
    again = _submit_all(engine, jobs)
    assert [None if e is None else (type(e).__name__, str(e)) for e in again] == _serial(gen, jobs)
    assert cache.stats()["verdicts"] == 2  # the two valid commits


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_single_flight_followers_get_the_leaders_route_error(chain, card, fault):
    gen, node = chain
    client = _client(gen, node)  # its trust root checked while the card works
    plane = LightServingPlane([client], device=CPU)
    before = sorted(client.store._by_height)
    card["fault"] = fault
    got, lock = [], threading.Lock()

    def request():
        try:
            with plane.open_session() as s:
                out = s.verified_block(TARGET)
        except Exception as e:  # the outcome under test, whatever its type
            out = e
        with lock:
            got.append(out)

    threads = [threading.Thread(target=request) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors = [e for e in got if isinstance(e, DeviceRouteError)]
    assert len(errors) == len(got) == 8, got
    # the leader's error, unchanged: at most one per flight that ran
    assert len({id(e) for e in errors}) <= plane.cache.misses
    assert plane.cache.stats()["published"] == 0 and len(plane.cache) == 0
    assert plane.cache.stats()["verdicts"] == 0
    assert sorted(client.store._by_height) == before
    card["fault"] = None
    with plane.open_session() as s:
        served = s.verified_block(TARGET)
    assert served.hash() == _client(gen, node).verify_light_block_at_height(TARGET).hash()
    assert plane.cache.peek(TARGET) is served


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_proxy_answers_internal_error_naming_the_route_and_keeps_serving(chain, card, fault):
    gen, node = chain

    async def main():
        client = _client(gen, node)
        proxy = LightProxy(client, "127.0.0.1:1")
        await proxy.start("127.0.0.1:0")
        base = f"http://{proxy.listen_addr}"
        try:
            async with aiohttp.ClientSession() as http:
                card["fault"] = fault
                async with http.get(f"{base}/header?height={TARGET}") as r:
                    failed = await r.json()
                async with http.get(f"{base}/serving_status") as r:
                    status = (await r.json())["result"]
                card["fault"] = None
                async with http.get(f"{base}/header?height={TARGET}") as r:
                    ok = await r.json()
            return failed, status, ok
        finally:
            await proxy.stop()

    failed, status, ok = asyncio.run(asyncio.wait_for(main(), 90))
    err = failed["error"]
    assert err["code"] == -32603 and "verify route failed" in err["message"]
    assert "verification failed" not in err["message"]
    # the failed request's session closed: the one open is the status request's
    assert status["cache"]["published"] == 0 and status["sessions"] == 1
    assert ok["result"]["verified"] is True
    want = StoreBackedProvider(gen.chain_id, node.block_store, node.state_store).light_block(TARGET)
    assert ok["result"]["header"]["app_hash"] == want.header.app_hash.hex().upper()
