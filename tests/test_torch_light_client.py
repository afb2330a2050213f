"""The JAX package's light-client tests, run against the port.

Ports of the light cases of ``tests/test_sync.py`` (bisection,
sequential, witness divergence, the witness and primary lifecycle,
proposer-priority divergence, invalid conflicting witnesses, a forged
commit), of ``tests/test_light_store.py`` and of
``tests/test_light_backwards.py``. Each scenario is written once over
a namespace of one package's classes and runs on both: one genesis
(seeded keys, backdated an hour) builds a byte-identical chain in each
package (``tests/test_torch_replay.py`` holds that parity), the port
verifies on ``device="cpu"`` (the host plane) and the JAX package on
its "cpu" backend. The reference's assertions hold on each package,
and every value a scenario returns (hashes, hops, cache counters,
error types and messages, witness counts) must be equal across them.
"""

import dataclasses
import functools
import time
from types import SimpleNamespace

import pytest
import torch

import cometbft_tpu.light as jlight
import cometbft_tpu.types as JT
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.light import client as jclient
from cometbft_tpu.light import detector as jdetector
from cometbft_tpu.light import provider as jprovider
from cometbft_tpu.light import store as jstore
from cometbft_tpu.light import verifier as jverifier
from cometbft_tpu.light.types import LightBlock as JLightBlock
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch import light
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.light import client as pclient
from cometbft_tpu_torch.light import detector as pdetector
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import store as pstore
from cometbft_tpu_torch.light import verifier as pverifier
from cometbft_tpu_torch.light.types import LightBlock
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.types.block import Commit, CommitSig
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.utils import chaingen, kv

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def backends():
    """The port on a two-worker host plane, the JAX package on its cpu
    backend; both restored after each test."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    old = jbatch._default_backend
    jbatch.set_default_backend("cpu")
    yield
    jbatch.set_default_backend(old)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


PORT = SimpleNamespace(
    Client=functools.partial(pclient.Client, device=CPU),
    TrustOptions=pclient.TrustOptions,
    LightClientError=pclient.LightClientError,
    SEQUENTIAL=light.SEQUENTIAL,
    StoreBackedProvider=pprovider.StoreBackedProvider,
    LightBlockNotFound=pprovider.LightBlockNotFound,
    LightStore=pstore.LightStore,
    DBLightStore=pstore.DBLightStore,
    open_kv=kv.open_kv,
    LightBlock=LightBlock,
    DivergenceError=pdetector.DivergenceError,
    ProposerPrioritiesDivergeError=pdetector.ProposerPrioritiesDivergeError,
    verify_non_adjacent=functools.partial(pverifier.verify_non_adjacent, device=CPU),
    ValidatorSet=ValidatorSet,
    CommitSig=CommitSig,
    Commit=Commit,
    make_chain=functools.partial(chaingen.make_chain, device=CPU),
)
JAX = SimpleNamespace(
    Client=jclient.Client,
    TrustOptions=jclient.TrustOptions,
    LightClientError=jclient.LightClientError,
    SEQUENTIAL=jlight.SEQUENTIAL,
    StoreBackedProvider=jprovider.StoreBackedProvider,
    LightBlockNotFound=jprovider.LightBlockNotFound,
    LightStore=jstore.LightStore,
    DBLightStore=jstore.DBLightStore,
    open_kv=jkv.open_kv,
    LightBlock=JLightBlock,
    DivergenceError=jdetector.DivergenceError,
    ProposerPrioritiesDivergeError=jdetector.ProposerPrioritiesDivergeError,
    verify_non_adjacent=jverifier.verify_non_adjacent,
    ValidatorSet=JT.ValidatorSet,
    CommitSig=JT.CommitSig,
    Commit=JT.Commit,
    make_chain=jchaingen.make_chain,
)


def chain_pair(n_vals, chain_id, n_blocks, txs=1, seed=5):
    """One genesis and its keys, a chain of ``n_blocks`` built by each
    package: {"port": (gen, privs, node), "jax": (...)}."""
    gen, privs = make_genesis(n_vals, chain_id=chain_id, seed=seed,
                              genesis_time_ns=time.time_ns() - 3_600_000_000_000)
    jgen = JGenesisDoc.from_json(gen.to_json())
    jprivs = [JPriv.from_seed(p.seed) for p in privs]
    return {
        "port": (gen, privs, PORT.make_chain(gen, privs, n_blocks, txs_per_block=txs)),
        "jax": (jgen, jprivs, JAX.make_chain(jgen, jprivs, n_blocks, txs_per_block=txs)),
    }


def both(scenario, chains, *args):
    """Run ``scenario(P, gen, privs, node, *args)`` on each package and
    require equal returns."""
    got = {name: scenario(P, *chains[name], *args) for name, P in (("port", PORT), ("jax", JAX))}
    assert got["port"] == got["jax"]
    return got["port"]


def provider_of(P, gen, node):
    return P.StoreBackedProvider(gen.chain_id, node.block_store, node.state_store)


def trust(P, root, height=1, period_ns=10**18):
    return P.TrustOptions(period_ns=period_ns, height=height, hash=root.hash())


# --- tests/test_sync.py, the light cases ----------------------------------


N_VALS = 4
CHAIN_LEN = 30


@pytest.fixture(scope="module")
def sync_chains():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        return chain_pair(N_VALS, "sync-chain", CHAIN_LEN)
    finally:
        pv.set_engine(None)
        eng.close()


def test_light_client_bisection(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(1)), provider)
        target_h = src.block_store.height()
        lb = client.verify_light_block_at_height(target_h)
        assert lb.height == target_h
        assert lb.hash() == src.block_store.load_block_meta(target_h).block_id.hash
        # skipping mode: with a static valset the jump is direct
        assert client.hops <= 3
        assert client.cache.hits + client.cache.misses > 0
        return bytes(lb.hash()), client.hops, client.cache.hits, client.cache.misses

    both(scenario, sync_chains)


def test_light_client_sequential(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(1)), provider,
                          verification_mode=P.SEQUENTIAL)
        lb = client.verify_light_block_at_height(10)
        assert lb.height == 10
        assert client.hops == 9
        return bytes(lb.hash()), client.hops, len(client.store)

    both(scenario, sync_chains)


def test_light_client_detects_witness_divergence(sync_chains):
    def scenario(P, gen, privs, src):
        # a forked witness chain: same genesis, different blocks
        fork = P.make_chain(gen, privs, 12, txs_per_block=2)
        provider = provider_of(P, gen, src)
        witness = provider_of(P, gen, fork)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(1)), provider,
                          witnesses=[witness])
        with pytest.raises(P.DivergenceError) as e:
            client.verify_light_block_at_height(10)
        assert witness.reported or provider.reported
        # the diverging witness is dropped from rotation
        assert witness not in client.witnesses
        ev = e.value.evidence
        return (e.value.witness_idx, ev.common_height, ev.conflicting_block.height,
                len(ev.byzantine_validators), len(witness.reported), len(provider.reported))

    both(scenario, sync_chains)


def test_dead_witness_pruned_during_verification(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)

        class DeadWitness:
            calls = 0

            def light_block(self, height):
                DeadWitness.calls += 1
                raise ConnectionError("witness unreachable")

            def report_evidence(self, ev):
                pass

        good = provider_of(P, gen, src)
        dead = DeadWitness()
        root = provider.light_block(1)
        client = P.Client(gen.chain_id, trust(P, root), provider, witnesses=[good, dead],
                          verification_mode=P.SEQUENTIAL)
        # one cross-check (and so one strike) per verified target height
        for h in (5, 8, 10):
            assert client.verify_light_block_at_height(h).height == h
        assert dead not in client.witnesses, "dead witness not pruned"
        assert good in client.witnesses
        assert DeadWitness.calls == client.MAX_WITNESS_STRIKES
        # a runtime replacement keeps the rotation healthy
        client.add_witness(provider_of(P, gen, src))
        assert len(client.witnesses) == 2
        client.verify_light_block_at_height(15)
        # a client whose last witness strikes out errors, never decays
        lone = P.Client(gen.chain_id, trust(P, root), provider, witnesses=[DeadWitness()],
                        verification_mode=P.SEQUENTIAL)
        with pytest.raises(P.LightClientError, match="no witnesses remain") as e:
            for h in (5, 8, 10):
                lone.verify_light_block_at_height(h)
        return DeadWitness.calls, client.hops, str(e.value)

    both(scenario, sync_chains)


def test_unresponsive_primary_replaced_by_witness(sync_chains):
    def scenario(P, gen, privs, src):
        class FlakyPrimary:
            def __init__(self, real):
                self.real = real
                self.dead = False

            def light_block(self, height):
                if self.dead:
                    raise ConnectionError("primary down")
                return self.real.light_block(height)

            def report_evidence(self, ev):
                pass

        real = provider_of(P, gen, src)
        primary, witness = FlakyPrimary(real), FlakyPrimary(real)
        client = P.Client(gen.chain_id, trust(P, real.light_block(1)), primary,
                          witnesses=[witness])
        client.verify_light_block_at_height(5)
        primary.dead = True
        lb = client.verify_light_block_at_height(10)
        assert lb.height == 10
        assert client.primary is witness, "witness was not promoted"
        assert client.witnesses == [primary]
        witness.dead = True
        with pytest.raises(P.LightClientError, match="no witness could") as e:
            client.verify_light_block_at_height(15)
        return bytes(lb.hash()), client.hops, str(e.value)

    both(scenario, sync_chains)


def test_pruned_primary_promoted_and_notfound_never_strikes(sync_chains):
    def scenario(P, gen, privs, src):
        real = provider_of(P, gen, src)

        class PrunedPrimary:
            def light_block(self, height):
                if 0 < height < 8:
                    raise P.LightBlockNotFound(f"height {height} pruned")
                return real.light_block(height)

            def report_evidence(self, ev):
                pass

        witness = provider_of(P, gen, src)
        root = real.light_block(10)
        # the first witness is pruned too: the probe keeps scanning
        client = P.Client(gen.chain_id, trust(P, root, height=10), PrunedPrimary(),
                          witnesses=[PrunedPrimary(), witness])
        lb = client.verify_light_block_at_height(5)  # backwards walk
        assert lb.height == 5
        assert client.primary is witness, "pruned primary not replaced"

        class NotFoundEverywhere:
            def light_block(self, height):
                raise P.LightBlockNotFound("beyond tip")

            def report_evidence(self, ev):
                pass

        client2 = P.Client(gen.chain_id, trust(P, root, height=10), real,
                           witnesses=[NotFoundEverywhere()])
        for _ in range(5):
            with pytest.raises(P.LightBlockNotFound):
                client2.verify_light_block_at_height(10_000)
        assert len(client2.witnesses) == 1, "witness burned by polls"
        return bytes(lb.hash()), client.hops, len(client.witnesses)

    both(scenario, sync_chains)


def test_proposer_priority_divergence_halts(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)

        class SkewedWitness:
            def __init__(self, real):
                self.real = real

            def light_block(self, height):
                lb = self.real.light_block(height)
                vs = lb.validator_set.copy()
                vs.validators[0] = dataclasses.replace(
                    vs.validators[0], proposer_priority=vs.validators[0].proposer_priority + 99)
                return dataclasses.replace(lb, validator_set=vs)

            def report_evidence(self, ev):
                pass

        root = provider.light_block(1)
        client = P.Client(gen.chain_id, trust(P, root), provider,
                          witnesses=[SkewedWitness(provider)])
        with pytest.raises(P.ProposerPrioritiesDivergeError) as e:
            client.verify_light_block_at_height(6)

        # a witness whose valset does not hash to the agreed header's
        # validators_hash is provably lying: removed, never a halt
        class FabricatedValsetWitness:
            def __init__(self, real):
                self.real = real

            def light_block(self, height):
                lb = self.real.light_block(height)
                return dataclasses.replace(
                    lb, validator_set=P.ValidatorSet(lb.validator_set.validators[:-1]))

            def report_evidence(self, ev):
                pass

        good = provider_of(P, gen, src)
        liar = FabricatedValsetWitness(provider)
        client2 = P.Client(gen.chain_id, trust(P, root), provider, witnesses=[good, liar])
        lb = client2.verify_light_block_at_height(6)
        assert lb.height == 6
        assert liar not in client2.witnesses
        assert good in client2.witnesses
        return e.value.witness_idx, str(e.value), bytes(lb.hash()), len(client2.witnesses)

    both(scenario, sync_chains)


def test_invalid_conflict_witness_removed_without_halt(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)

        class BadBlockWitness:
            def __init__(self, real):
                self.real = real

            def light_block(self, height):
                lb = self.real.light_block(height)
                return dataclasses.replace(
                    lb, header=dataclasses.replace(lb.header, time_ns=lb.header.time_ns + 1))

            def report_evidence(self, ev):
                pass

        good = provider_of(P, gen, src)
        bad = BadBlockWitness(provider)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(1)), provider,
                          witnesses=[good, bad])
        lb = client.verify_light_block_at_height(10)
        assert lb.height == 10
        assert bad not in client.witnesses
        assert good in client.witnesses
        return bytes(lb.hash()), len(client.witnesses)

    both(scenario, sync_chains)


def test_verifier_rejects_forged_commit(sync_chains):
    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)
        lb1 = provider.light_block(1)
        lb5 = provider.light_block(5)
        # forge: drop enough signatures to fall under 2/3
        sigs = [P.CommitSig.absent() if i < 2 else cs for i, cs in enumerate(lb5.commit.signatures)]
        forged = P.Commit(lb5.commit.height, lb5.commit.round, lb5.commit.block_id, sigs)
        bad = P.LightBlock(header=lb5.header, commit=forged, validator_set=lb5.validator_set)
        with pytest.raises(Exception) as e:
            P.verify_non_adjacent(gen.chain_id, lb1, lb1.validator_set, bad, bad.validator_set,
                                  10**18)
        return type(e.value).__name__, str(e.value)

    both(scenario, sync_chains)


# --- tests/test_light_store.py ----------------------------------------------


def test_db_light_store_roundtrip_and_resume(tmp_path):
    chains = chain_pair(3, "light-db", 12, seed=6)

    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)
        root = provider.light_block(1)
        opts = trust(P, root, period_ns=7200 * 10**9)
        path = str(tmp_path / f"light-{id(P)}.db")
        store = P.DBLightStore(P.open_kv("sqlite", path), "light-db")
        cli = P.Client("light-db", opts, primary=provider, store=store)
        lb = cli.verify_light_block_at_height(9)
        assert lb.height == 9
        store.db.close()

        # reopen: the persisted roots load; the same trust root resumes
        store2 = P.DBLightStore(P.open_kv("sqlite", path), "light-db")
        assert len(store2) == len(store)
        got = store2.get(9)
        assert got is not None and got.hash() == lb.hash()
        assert got.validator_set.hash() == lb.validator_set.hash()
        cli2 = P.Client("light-db", opts, primary=provider, store=store2)
        assert cli2.verify_light_block_at_height(11).height == 11

        # a mismatched trust root against the persisted store is an error
        bad_root = P.TrustOptions(period_ns=7200 * 10**9, height=1, hash=b"\x00" * 32)
        with pytest.raises(P.LightClientError, match="re-rooting"):
            P.Client("light-db", bad_root, primary=provider, store=store2)

        # pruning removes the durable copies as well
        store2.prune(1)
        store2.db.close()
        store3 = P.DBLightStore(P.open_kv("sqlite", path), "light-db")
        assert len(store3) == 1

        # sparse store: the root is compared against the primary's header
        bad_root = P.TrustOptions(period_ns=7200 * 10**9, height=1, hash=b"\x11" * 32)
        with pytest.raises(P.LightClientError, match="re-rooting"):
            P.Client("light-db", bad_root, primary=provider, store=store3)
        P.Client("light-db", opts, primary=provider, store=store3)

        # chain-id prefix isolation
        assert len(P.DBLightStore(store3.db, "other-chain")) == 0
        kept = sorted(store3._by_height)
        store3.db.close()
        return bytes(lb.hash()), len(store), kept

    both(scenario, chains)


def test_sparse_store_trust_check_anchors_to_chain():
    chains = chain_pair(3, "light-anchor", 12, seed=8)

    def scenario(P, gen, privs, src):
        provider = provider_of(P, gen, src)
        root = provider.light_block(1)

        def sparse_client(primary, trust_hash):
            store = P.LightStore()
            cli = P.Client("light-anchor", trust(P, root, period_ns=7200 * 10**9),
                           primary=provider, store=store)
            cli.verify_light_block_at_height(9)
            store.prune(1)
            return P.Client("light-anchor",
                            P.TrustOptions(period_ns=7200 * 10**9, height=1, hash=trust_hash),
                            primary=primary, store=store)

        class ForgingProvider:
            """A forged header at the trust height whose hash matches the
            mis-rooted configured hash; genuine everywhere else."""

            def __init__(self):
                genuine = provider.light_block(1)
                self.forged = dataclasses.replace(
                    genuine,
                    header=dataclasses.replace(genuine.header, time_ns=genuine.header.time_ns + 1))

            def light_block(self, height):
                return self.forged if height == 1 else provider.light_block(height)

        forger = ForgingProvider()
        with pytest.raises(P.LightClientError, match="does not chain") as e1:
            sparse_client(forger, bytes(forger.forged.hash()))

        class DeadProvider:
            def light_block(self, height):
                raise ConnectionError("primary unreachable")

        # unreachable primary: resume from the store
        cli = sparse_client(DeadProvider(), b"\x77" * 32)
        assert cli.store.latest() is not None

        # forged header above the lowest stored block: the skipping
        # path's assorted errors classify as a refusal
        store2 = P.LightStore()
        for h in (2, 9):
            store2.save(provider.light_block(h))
        genuine5 = provider.light_block(5)
        forged5 = dataclasses.replace(
            genuine5,
            header=dataclasses.replace(genuine5.header, time_ns=genuine5.header.time_ns + 1))

        class MidForger:
            def light_block(self, height):
                return forged5 if height == 5 else provider.light_block(height)

        with pytest.raises(P.LightClientError, match="does not chain") as e2:
            P.Client("light-anchor",
                     P.TrustOptions(period_ns=7200 * 10**9, height=5, hash=bytes(forged5.hash())),
                     primary=MidForger(), store=store2)
        return str(e1.value), str(e2.value), cli.store.latest().height

    both(scenario, chains)


# --- tests/test_light_backwards.py ------------------------------------------


@pytest.fixture(scope="module")
def back_chains():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        return chain_pair(4, "back-chain", 20, seed=9)
    finally:
        pv.set_engine(None)
        eng.close()


def _header_swap(P, gen, node, at, **changes):
    """A provider of ``node`` whose header at ``at`` has ``changes``."""

    class Swap(P.StoreBackedProvider):
        def light_block(self, height):
            lb = super().light_block(height)
            if height == at:
                lb = type(lb)(dataclasses.replace(lb.header, **changes), lb.commit,
                              lb.validator_set)
            return lb

    return Swap(gen.chain_id, node.block_store, node.state_store)


def test_backwards_walk_to_earlier_height(back_chains):
    def scenario(P, gen, privs, node):
        provider = provider_of(P, gen, node)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(15), height=15,
                                              period_ns=3600 * 10**9 * 24), provider)
        lb = client.verify_light_block_at_height(5)
        assert lb.height == 5
        assert client.hops == 10  # walked 10 hash-chain hops
        again = client.verify_light_block_at_height(5)
        assert again.hash() == lb.hash()
        return bytes(lb.hash()), client.hops

    both(scenario, back_chains)


@pytest.mark.parametrize("at, changes, match", [
    (7, {"app_hash": b"\xff" * 32}, "chain broken"),
    (9, {"time_ns": 10**15}, "non-monotonic"),
    (9, {"chain_id": "evil"}, "chain"),
], ids=["forged_header", "non_monotonic_time", "wrong_chain_id"])
def test_backwards_rejects(back_chains, at, changes, match):
    """The three refusals of the backwards walk (tests/test_light_backwards.py:
    a forged header breaks the hash chain; a header pushed past the
    trust root's time fails the time check first; a foreign chain id
    is refused)."""

    def scenario(P, gen, privs, node):
        if "time_ns" in changes:  # jump past the trust root's time
            shift = node.block_store.load_block_meta(at).header.time_ns
            kw = {"time_ns": shift + changes["time_ns"]}
        else:
            kw = changes
        provider = _header_swap(P, gen, node, at, **kw)
        client = P.Client(gen.chain_id, trust(P, provider.light_block(12), height=12,
                                              period_ns=3600 * 10**9), provider)
        with pytest.raises((P.LightClientError, ValueError), match=match) as e:
            client.verify_light_block_at_height(5)
        return type(e.value).__name__, str(e.value)

    both(scenario, back_chains)
