"""The port's light serving plane (``light/serving.py``), its client
seams and HTTP provider held to the JAX package's
(``tests/test_light_serving.py``, 19 of its 21 cases: the two metrics
cases wait for ROADMAP A10).

Each case is written once over a namespace of one package's classes
and runs on both, on byte-identical chains (one seeded genesis; the
port verifies on ``device="cpu"``, the JAX package on its "cpu"
backend). The reference's assertions hold on each package, and what a
case returns (cache counters, verdicts, served hashes, span names,
errors) must be equal across them: the shared verified-header cache
(TTL, LRU, refusal of inconsistent blocks, single flight on success
and failure), the coalescing engine (serial-equivalent verdicts, the
verdict cache), sessions and admission, spans, divergence detection
riding the cache, the HTTP provider's bounded retry, the health route
and the proxy through the plane.
"""

import asyncio
import dataclasses
import functools
import random
import threading
import time
from fractions import Fraction
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
import torch

import cometbft_tpu.types as JT
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.light import client as jclient
from cometbft_tpu.light import detector as jdetector
from cometbft_tpu.light import http_provider as jhttp
from cometbft_tpu.light import provider as jprovider
from cometbft_tpu.light import proxy as jproxy
from cometbft_tpu.light import serving as jserving
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu.obs import QueueRegistry as JQueueRegistry
from cometbft_tpu.rpc import client as jrpcclient
from cometbft_tpu.rpc import core as jcore
from cometbft_tpu.rpc import env as jenv
from cometbft_tpu.statesync import stateprovider as jstateprovider
from cometbft_tpu.trace.tracer import Tracer as JTracer
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.light import client as pclient
from cometbft_tpu_torch.light import detector as pdetector
from cometbft_tpu_torch.light import http_provider as phttp
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import proxy as pproxy
from cometbft_tpu_torch.light import serving as pserving
from cometbft_tpu_torch.light.types import LightBlock as PLightBlock
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.obs import QueueRegistry as PQueueRegistry
from cometbft_tpu_torch.rpc import client as prpcclient
from cometbft_tpu_torch.rpc import core as pcore
from cometbft_tpu_torch.rpc import env as penv
from cometbft_tpu_torch.statesync import stateprovider as pstateprovider
from cometbft_tpu_torch.trace.tracer import Tracer as PTracer
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.validator_set import Validator as PValidator
from cometbft_tpu_torch.types.validator_set import ValidatorSet as PValidatorSet
from cometbft_tpu_torch.utils import chaingen as pchaingen
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
N_VALS = 4
CHAIN_LEN = 14
TRUST_PERIOD_NS = 24 * 3600 * 10**9


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


def _port_tracer():
    """(tracer, names of its spans so far): the port's tracer feeds
    observers, the JAX one keeps a ring."""
    t, names = PTracer(name="t"), set()
    t.add_observer(lambda name, dur, args: names.add(name))
    return t, lambda: names


def _jax_tracer():
    t = JTracer(name="t", size=4096)
    return t, lambda: {e["name"] for e in t.snapshot()}


PORT = SimpleNamespace(
    name="port", serving=pserving, Client=functools.partial(pclient.Client, device=CPU),
    TrustOptions=pclient.TrustOptions, LightClientError=pclient.LightClientError,
    SEQUENTIAL=pclient.SEQUENTIAL, DivergenceError=pdetector.DivergenceError,
    StoreBackedProvider=pprovider.StoreBackedProvider, LightBlock=PLightBlock,
    ValidatorSet=PValidatorSet, Validator=PValidator, Priv=PPriv, BlockID=pblock.BlockID,
    PartSetHeader=pblock.PartSetHeader, Vote=pvote.Vote, PRECOMMIT=pvote.PRECOMMIT,
    CommitSig=pblock.CommitSig, BLOCK_ID_FLAG_COMMIT=pblock.BLOCK_ID_FLAG_COMMIT, Commit=pblock.Commit,
    verify_commit_light=functools.partial(pvalidation.verify_commit_light, device=CPU),
    verify_commit_light_trusting=functools.partial(pvalidation.verify_commit_light_trusting, device=CPU),
    CommitVerifyError=pvalidation.CommitVerifyError, on_device={"device": CPU},
    QueueRegistry=PQueueRegistry, tracer=_port_tracer,
    HTTPProvider=phttp.HTTPProvider, RPCClientError=prpcclient.RPCClientError,
    LightBlockNotFound=pprovider.LightBlockNotFound, ProviderError=pprovider.ProviderError,
    HTTPClient=prpcclient.HTTPClient, health=pcore.health, Environment=penv.Environment,
    LightProxy=pproxy.LightProxy, RPC_OVERLOADED=pproxy.RPC_OVERLOADED,
    make_chain=functools.partial(pchaingen.make_chain, device=CPU),
    stateprovider=pstateprovider,
)
JAX = SimpleNamespace(
    name="jax", serving=jserving, Client=jclient.Client, TrustOptions=jclient.TrustOptions,
    LightClientError=jclient.LightClientError, SEQUENTIAL=jclient.SEQUENTIAL,
    DivergenceError=jdetector.DivergenceError, StoreBackedProvider=jprovider.StoreBackedProvider,
    LightBlock=JLightBlock, ValidatorSet=JT.ValidatorSet, Validator=JT.Validator, Priv=JPriv,
    BlockID=JT.BlockID, PartSetHeader=JT.PartSetHeader, Vote=JT.Vote, PRECOMMIT=JT.PRECOMMIT,
    CommitSig=JT.CommitSig, BLOCK_ID_FLAG_COMMIT=JT.BLOCK_ID_FLAG_COMMIT, Commit=JT.Commit,
    verify_commit_light=JT.verify_commit_light, verify_commit_light_trusting=JT.verify_commit_light_trusting,
    CommitVerifyError=JT.CommitVerifyError, on_device={}, QueueRegistry=JQueueRegistry,
    tracer=_jax_tracer, HTTPProvider=jhttp.HTTPProvider,
    RPCClientError=jrpcclient.RPCClientError, LightBlockNotFound=jprovider.LightBlockNotFound,
    ProviderError=jprovider.ProviderError, HTTPClient=jrpcclient.HTTPClient, health=jcore.health,
    Environment=jenv.Environment, LightProxy=jproxy.LightProxy, RPC_OVERLOADED=jproxy.RPC_OVERLOADED,
    make_chain=jchaingen.make_chain, stateprovider=jstateprovider,
)


@pytest.fixture(scope="module")
def chains():
    """One genesis and its keys, a 14-block chain built by each package
    (byte-identical, tests/test_torch_replay.py)."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(N_VALS, chain_id="serve-chain", seed=13,
                                  genesis_time_ns=time.time_ns() - 3_600_000_000_000)
        jgen = JGenesisDoc.from_json(gen.to_json())
        jprivs = [JPriv.from_seed(p.seed) for p in privs]
        out = {"port": (gen, privs, PORT.make_chain(gen, privs, CHAIN_LEN)),
               "jax": (jgen, jprivs, JAX.make_chain(jgen, jprivs, CHAIN_LEN))}
        yield out
        for _, _, node in out.values():
            node.close_stores()
    finally:
        pv.set_engine(None)
        eng.close()


def both(case, chains, *args):
    """Run ``case(P, gen, privs, node, *args)`` on each package and
    require equal returns."""
    got = {name: case(P, *chains[name], *args) for name, P in (("jax", JAX), ("port", PORT))}
    assert got["port"] == got["jax"]
    return got["port"]


def provider(P, gen, node):
    return P.StoreBackedProvider(gen.chain_id, node.block_store, node.state_store)


def client(P, gen, node, prov=None, **kw):
    prov = prov or provider(P, gen, node)
    root = prov.light_block(1)
    return P.Client(gen.chain_id, P.TrustOptions(period_ns=TRUST_PERIOD_NS, height=1, hash=root.hash()),
                    prov, **kw)


def plane(P, clients, **kw):
    return P.serving.LightServingPlane(clients, **kw, **P.on_device)


def engine(P, chain_id, **kw):
    return P.serving.CoalescedCommitVerifier(chain_id, **kw, **P.on_device)


def forged_commit(P, commit):
    sig0 = dataclasses.replace(commit.signatures[0], signature=bytes(64))
    return dataclasses.replace(commit, signatures=[sig0] + list(commit.signatures[1:]))


# --- VerifiedHeaderCache ------------------------------------------------


def test_cache_hit_miss_ttl_and_lru(chains, monkeypatch):
    def case(P, gen, privs, node):
        lb5 = provider(P, gen, node).light_block(5)
        cache = P.serving.VerifiedHeaderCache(gen.chain_id, max_entries=2, ttl_s=100.0)
        assert cache.get(5) is None and cache.misses == 1
        cache.publish(lb5)
        assert cache.get(5) is lb5 and cache.hits == 1
        now = [time.monotonic()]
        monkeypatch.setattr(P.serving, "_monotonic", lambda: now[0])
        cache2 = P.serving.VerifiedHeaderCache(gen.chain_id, ttl_s=10.0)
        cache2.publish(lb5)
        assert cache2.get(5) is lb5
        now[0] += 11.0
        assert cache2.get(5) is None and cache2.expired == 1
        prov = provider(P, gen, node)
        cache.publish(prov.light_block(6))
        cache.publish(prov.light_block(7))
        assert len(cache) == 2 and cache.peek(5) is None
        assert cache.latest_before(7).height == 6 and cache.latest_before(6) is None
        return cache.stats(), cache2.stats()

    both(case, chains)


def test_cache_refuses_inconsistent_blocks(chains):
    def case(P, gen, privs, node):
        lb = provider(P, gen, node).light_block(5)
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        poisoned = P.LightBlock(header=dataclasses.replace(lb.header, app_hash=b"\x55" * 32),
                                commit=lb.commit, validator_set=lb.validator_set)
        with pytest.raises(P.serving.CachePoisonError) as e1:
            cache.publish(poisoned)
        assert len(cache) == 0
        with pytest.raises(P.serving.CachePoisonError) as e2:
            P.serving.VerifiedHeaderCache("other-chain").publish(lb)
        return str(e1.value), str(e2.value)

    both(case, chains)


def test_failed_verification_publishes_nothing(chains):
    def case(P, gen, privs, node):
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        calls, errs = [], []

        def bad_verify(height):
            calls.append(height)
            time.sleep(0.05)
            raise P.LightClientError("verification failed")

        def req():
            try:
                cache.get_or_verify(9, bad_verify)
            except P.LightClientError as e:
                errs.append(e)

        ths = [threading.Thread(target=req) for _ in range(6)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert len(calls) == 1 and len(errs) == 6  # single flight even on failure
        assert len(cache) == 0 and cache.peek(9) is None
        return len(calls), [str(e) for e in errs]

    both(case, chains)


def test_single_flight_dedups_concurrent_requests(chains):
    def case(P, gen, privs, node):
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        lb8 = provider(P, gen, node).light_block(8)
        calls, got = [], []

        def verify(height):
            calls.append(height)
            time.sleep(0.05)
            return lb8

        ths = [threading.Thread(target=lambda: got.append(cache.get_or_verify(8, verify))) for _ in range(10)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert len(calls) == 1 and all(b is lb8 for b in got)
        assert cache.flight_waits >= 1 and cache.peek(8) is lb8
        return len(calls), len(got), bytes(lb8.hash())

    both(case, chains)


# --- coalesced verification --------------------------------------------


def test_coalesced_verdicts_serial_equivalent(chains):
    def case(P, gen, privs, node):
        good = provider(P, gen, node).light_block(5)
        forged = forged_commit(P, good.commit)
        rng = np.random.default_rng(77)
        foreign = P.ValidatorSet([P.Validator(P.Priv.from_seed(rng.bytes(32)).pub_key(), 100) for _ in range(4)])
        jobs = [("light", good.validator_set, good.commit.block_id, good.height, good.commit),
                ("light", good.validator_set, good.commit.block_id, good.height, forged),
                ("trusting", good.validator_set, good.commit, Fraction(1, 3)),
                ("trusting", foreign, good.commit, Fraction(1, 3))]

        def serial(job):
            try:
                if job[0] == "light":
                    P.verify_commit_light(gen.chain_id, *job[1:])
                else:
                    P.verify_commit_light_trusting(gen.chain_id, job[1], job[2], trust_level=job[3])
                return None
            except P.CommitVerifyError as e:
                return type(e).__name__, str(e)

        want = [serial(j) for j in jobs]
        assert want[1][0] == "ErrInvalidSignature" and want[3][0] == "ErrNotEnoughVotingPower"
        eng = engine(P, gen.chain_id, window_s=0.2)
        got = [None] * len(jobs)

        def submit(i, job):
            try:
                if job[0] == "light":
                    eng.verify_commit_light(*job[1:])
                else:
                    eng.verify_commit_light_trusting(*job[1:])
            except P.CommitVerifyError as e:
                got[i] = type(e).__name__, str(e)

        ths = [threading.Thread(target=submit, args=(i, j)) for i, j in enumerate(jobs)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert got == want
        st = eng.stats()
        assert st["submitted"] == 4 and st["max_batch"] >= 2
        return want

    both(case, chains)


def test_verdict_cache_skips_reverification(chains):
    def case(P, gen, privs, node):
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        eng = engine(P, gen.chain_id, verdict_cache=cache, window_s=0.001)
        lb = provider(P, gen, node).light_block(6)
        eng.verify_commit_light(lb.validator_set, lb.commit.block_id, lb.height, lb.commit)
        assert eng.dispatches == 1
        lb2 = provider(P, gen, node).light_block(6)
        assert lb2 is not lb
        eng.verify_commit_light(lb2.validator_set, lb2.commit.block_id, lb2.height, lb2.commit)
        assert eng.dispatches == 1 and eng.verdict_hits == 1
        forged = forged_commit(P, lb.commit)
        errs = []
        for _ in range(2):
            with pytest.raises(P.CommitVerifyError) as e:
                eng.verify_commit_light(lb.validator_set, lb.commit.block_id, lb.height, forged)
            errs.append((type(e.value).__name__, str(e.value)))
        assert eng.dispatches == 3
        return errs, eng.stats()

    both(case, chains)


# --- sessions / admission ----------------------------------------------


def test_plane_shares_verification_across_sessions(chains):
    def case(P, gen, privs, node):
        prov = provider(P, gen, node)
        pl = plane(P, [client(P, gen, node, prov), client(P, gen, node, prov)])
        results = []

        def one(h):
            with pl.open_session() as s:
                results.append(s.verified_block(h))

        ths = [threading.Thread(target=one, args=(4 + (i % 3),)) for i in range(12)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert len(results) == 12 and {lb.height for lb in results} == {4, 5, 6}
        st = pl.stats()
        assert st["cache"]["published"] <= CHAIN_LEN
        assert st["cache"]["flight_waits"] + st["cache"]["hits"] > 0
        before = st["cache"]["published"]
        for h in (4, 5, 6):
            with pl.open_session() as s:
                assert s.verified_block(h).height == h
        st2 = pl.stats()
        assert st2["cache"]["published"] == before and st2["cache"]["hits"] > 0
        return sorted({(lb.height, bytes(lb.hash())) for lb in results})

    both(case, chains)


def test_plane_session_bound_sheds_and_counts(chains):
    def case(P, gen, privs, node):
        pl = plane(P, [client(P, gen, node)], max_sessions=2)
        s1, s2 = pl.open_session(), pl.open_session()
        with pytest.raises(P.serving.ServingOverloadError) as e:
            pl.open_session()
        assert pl.sessions_shed == 1 and pl.gate.stats()["dropped"] >= 1
        s1.close()
        pl.open_session().close()
        s2.close()
        assert pl.active_sessions() == 0
        return str(e.value), pl.gate.stats()

    both(case, chains)


def test_plane_inflight_gate_sheds_under_storm(chains):
    def case(P, gen, privs, node):
        pl = plane(P, [client(P, gen, node)], max_inflight=1, admit_timeout_s=0.0)
        release, entered = threading.Event(), threading.Event()
        orig = pl._verify

        def slow_verify(height):
            entered.set()
            release.wait(5.0)
            return orig(height)

        pl._verify = slow_verify
        out = {}

        def leader():
            with pl.open_session() as s:
                out["leader"] = s.verified_block(9)

        t = threading.Thread(target=leader)
        t.start()
        assert entered.wait(5.0)
        with pytest.raises(P.serving.ServingOverloadError) as e:
            pl.serve(10)
        assert pl.requests_shed == 1
        release.set()
        t.join()
        assert out["leader"].height == 9
        return str(e.value), bytes(out["leader"].hash())

    both(case, chains)


def test_plane_queue_registry_contract(chains):
    def case(P, gen, privs, node):
        pl = plane(P, [client(P, gen, node)], max_inflight=7)
        reg = P.QueueRegistry()
        pl.register_queues(reg)
        st = reg.get("light.serve")
        assert st["maxsize"] == 7 and all(k in st for k in ("depth", "high_watermark", "enqueued", "dropped"))
        return st

    both(case, chains)


def test_serve_spans_recorded(chains):
    def case(P, gen, privs, node):
        tracer, span_names = P.tracer()
        pl = plane(P, [client(P, gen, node)], tracer=tracer)
        with pl.open_session() as s:
            s.verified_block(5)
            s.verified_block(5)
        names = span_names()
        assert {"light.serve.request", "light.cache.miss", "light.cache.hit", "light.verify.coalesced"} <= names
        return sorted(names)

    both(case, chains)


# --- divergence detection with the shared cache -------------------------


def forge_lunatic(P, gen, privs, node, height):
    """A valid-in-itself fork at ``height``: 2 of 4 validators (half the
    power: passes 1/3 trusting) sign a header claiming a set of just
    them (passes its own 2/3)."""
    real = node.block_store.load_block(height)
    vs = gen.validator_set()
    byz = [privs[2], privs[3]]
    by_addr = {p.pub_key().address(): p for p in byz}
    fvs = P.ValidatorSet([vs.get_by_address(p.pub_key().address())[1] for p in byz])
    header = dataclasses.replace(real.header, app_hash=b"\x66" * 32, validators_hash=fvs.hash(),
                                 next_validators_hash=fvs.hash())
    fbid = P.BlockID(header.hash(), P.PartSetHeader(1, header.hash()))
    sigs = []
    for i, val in enumerate(fvs.validators):
        v = P.Vote(type_=P.PRECOMMIT, height=height, round=0, block_id=fbid, timestamp_ns=header.time_ns,
                   validator_address=val.address, validator_index=i)
        sigs.append(P.CommitSig(block_id_flag=P.BLOCK_ID_FLAG_COMMIT, validator_address=val.address,
                                timestamp_ns=header.time_ns,
                                signature=by_addr[val.address].sign(v.sign_bytes(gen.chain_id))))
    return P.LightBlock(header=header, commit=P.Commit(height, 0, fbid, sigs), validator_set=fvs)


class ForkingProvider:
    """Honest store-backed provider, except at the attack height."""

    def __init__(self, P, gen, node, forged):
        self.inner = provider(P, gen, node)
        self.chain_id = gen.chain_id
        self.forged = forged
        self.reported = []

    def light_block(self, height):
        return self.forged if height == self.forged.height else self.inner.light_block(height)

    def report_evidence(self, ev):
        self.reported.append(ev)


def test_divergence_fires_through_cache_and_fork_never_cached(chains):
    def case(P, gen, privs, node):
        attack_h = 10
        forged = forge_lunatic(P, gen, privs, node, attack_h)
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        client(P, gen, node, header_cache=cache).verify_light_block_at_height(6)
        assert cache.peek(6) is not None
        primary = ForkingProvider(P, gen, node, forged)
        witness = provider(P, gen, node)
        byz = client(P, gen, node, prov=primary, witnesses=[witness], header_cache=cache)
        with pytest.raises(P.DivergenceError):
            byz.verify_light_block_at_height(attack_h)
        assert byz.store.get(6) is cache.peek(6)
        assert cache.peek(attack_h) is None
        for h in range(1, CHAIN_LEN + 1):
            ent = cache.peek(h)
            if ent is not None:
                assert bytes(ent.hash()) == bytes(node.block_store.load_block_meta(h).block_id.hash)
        assert primary.reported or witness.reported
        return sorted(h for h in range(1, CHAIN_LEN + 1) if cache.peek(h) is not None), \
            len(primary.reported), len(witness.reported)

    both(case, chains)


def test_intermediate_hops_cross_checked_before_publication(chains):
    def case(P, gen, privs, node):
        forged_at_hop = forge_lunatic(P, gen, privs, node, 5)
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        witness = ForkingProvider(P, gen, node, forged_at_hop)
        c = client(P, gen, node, witnesses=[witness], header_cache=cache, verification_mode=P.SEQUENTIAL)
        with pytest.raises(P.DivergenceError):
            c.verify_light_block_at_height(8)
        assert len(cache) == 0 and cache.published == 0
        return cache.stats()

    both(case, chains)


def test_cached_height_conflict_detected(chains):
    def case(P, gen, privs, node):
        h = 8
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        client(P, gen, node, header_cache=cache).verify_light_block_at_height(h)
        assert cache.peek(h) is not None
        forged = forge_lunatic(P, gen, privs, node, h)
        victim = client(P, gen, node, header_cache=cache)
        with pytest.raises(P.LightClientError, match="conflicts with") as e:
            victim.verify_header(forged, time.time_ns())
        assert bytes(cache.peek(h).hash()) == bytes(node.block_store.load_block_meta(h).block_id.hash)
        return str(e.value)

    both(case, chains)


# --- statesync sharing ----------------------------------------------------


def test_statesync_provider_shares_header_cache(chains, monkeypatch):
    """A joining node's light-verified restore rides verification work
    concurrent sessions already did (and the other way): heights a
    serving client verified come out of the shared cache with no
    fetches by the statesync client."""

    def case(P, gen, privs, node):
        class FakeHTTPProvider(P.StoreBackedProvider):
            """Counts fetches; stands in for the HTTP provider so the
            statesync wiring runs in process."""

            def __init__(self, chain_id, url, *a, **k):
                super().__init__(chain_id, node.block_store, node.state_store)
                self.fetches = 0

            def light_block(self, height):
                self.fetches += 1
                return super().light_block(height)

            def close(self):
                pass

        monkeypatch.setattr(P.stateprovider, "HTTPProvider", FakeHTTPProvider)
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        # a serving session verifies the restore heights first
        serving_client = client(P, gen, node, header_cache=cache)
        for h in (5, 6, 7):
            serving_client.verify_light_block_at_height(h)
        root = provider(P, gen, node).light_block(1)
        sp = P.stateprovider.LightClientStateProvider(
            gen.chain_id, ["fake://primary"], 1, bytes(root.hash()), TRUST_PERIOD_NS,
            header_cache=cache, **P.on_device,
        )
        fetched_after_init = sp.primary.fetches
        # app_hash(5) needs header 6, commit(6): both verified already
        app_hash = sp.app_hash(5)
        assert app_hash == bytes(node.block_store.load_block_meta(6).header.app_hash)
        assert sp.commit(6).height == 6
        assert sp.primary.fetches == fetched_after_init, "cached heights must not re-fetch"
        stats = sp.cache_stats()
        assert stats["hits"] > 0
        # what statesync verifies is published for the sessions
        before = cache.published
        sp.commit(9)
        assert cache.published > before
        sp.close()
        return app_hash, fetched_after_init, stats, cache.published - before

    both(case, chains)


# --- http provider and client --------------------------------------------


def test_http_provider_bounded_retry_with_jitter(chains):
    def case(P, gen, privs, node):
        lb3 = provider(P, gen, node).light_block(3)
        prov = P.HTTPProvider(gen.chain_id, "127.0.0.1:1", timeout_s=1.0, retries=3, rng=random.Random(7))
        try:
            attempts = []

            async def flaky(height):
                attempts.append(height)
                if len(attempts) < 3:
                    raise ConnectionError("transient")
                return lb3

            prov._light_block = flaky
            assert prov.light_block(3) is lb3
            assert len(attempts) == 3 and prov.retries_used == 2
            attempts.clear()

            async def not_found(height):
                attempts.append(height)
                raise P.RPCClientError(-32603, "height 99 not available")

            prov._light_block = not_found
            with pytest.raises(P.LightBlockNotFound):
                prov.light_block(99)
            assert len(attempts) == 1
            attempts.clear()

            async def dead(height):
                attempts.append(height)
                raise ConnectionError("down")

            prov._light_block = dead
            with pytest.raises(P.ProviderError, match="after 3 attempts") as e_dead:
                prov.light_block(3)
            assert len(attempts) == 3
            attempts.clear()
            prov._timeout_s = 0.2
            cancelled = []

            async def slow(height):
                attempts.append(height)
                try:
                    await asyncio.sleep(5.0)
                except asyncio.CancelledError:
                    cancelled.append(height)
                    raise
                return lb3

            prov._light_block = slow
            with pytest.raises(P.ProviderError, match="timed out") as e_slow:
                prov.light_block(3)
            assert len(attempts) == 1
            deadline = time.monotonic() + 2.0
            while not cancelled and time.monotonic() < deadline:
                time.sleep(0.01)
            assert cancelled == [3]
            return prov.retries_used, str(e_dead.value), str(e_slow.value)
        finally:
            prov.close()

    both(case, chains)


def test_http_client_session_reused(chains):
    def case(P, gen, privs, node):
        async def main():
            c = P.HTTPClient("127.0.0.1:1")
            s1, s2 = await c._sess(), await c._sess()
            assert s1 is s2
            await c.close()
            return True

        return asyncio.run(main())

    both(case, chains)


def test_health_reports_shared_header_cache(chains):
    def case(P, gen, privs, node):
        cache = P.serving.VerifiedHeaderCache(gen.chain_id)
        env = P.Environment(chain_id=gen.chain_id, block_store=node.block_store,
                            light_header_cache_fn=lambda: cache)
        assert "light_header_cache" not in P.health(env)
        client(P, gen, node, header_cache=cache).verify_light_block_at_height(5)
        out = P.health(env)
        assert out["light_header_cache"]["entries"] >= 1 and out["light_header_cache"]["published"] >= 1
        return out["light_header_cache"]

    both(case, chains)


# --- proxy integration --------------------------------------------------


def test_proxy_serves_through_plane_and_sheds(chains):
    def case(P, gen, privs, node):
        async def main():
            proxy = P.LightProxy(client(P, gen, node), "127.0.0.1:1", max_sessions=2, max_inflight=4)
            await proxy.start("127.0.0.1:0")
            try:
                base = f"http://{proxy.listen_addr}"
                async with aiohttp.ClientSession() as http:
                    async with http.get(f"{base}/header?height=5") as r:
                        body = await r.json()
                    assert body["result"]["verified"] is True
                    async with http.get(f"{base}/header?height=5") as r:
                        body2 = await r.json()
                    assert body2["result"]["header_b64"] == body["result"]["header_b64"]
                    async with http.get(f"{base}/serving_status") as r:
                        st = (await r.json())["result"]
                    assert st["requests"] >= 2 and st["cache"]["hits"] >= 1
                    held = [proxy.plane.open_session() for _ in range(2)]
                    async with http.get(f"{base}/header?height=6") as r:
                        shed = await r.json()
                    assert shed["error"]["code"] == P.RPC_OVERLOADED
                    for s in held:
                        s.close()
                    async with http.get(f"{base}/header?height=6") as r:
                        ok = await r.json()
                    assert ok["result"]["verified"] is True
                    return body["result"], ok["result"], shed["error"]
            finally:
                await proxy.stop()

        return asyncio.run(asyncio.wait_for(main(), 120))

    both(case, chains)
