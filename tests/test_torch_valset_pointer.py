"""The validator-set pointer records of the port's state store, held to
the JAX package's (``tests/test_valset_pointer.py``; reference
state/store.go:185-251, 590-640).

All nine reference cases. Each runs on both packages from the same
inputs (keys from ``np.random.default_rng`` seeds, the same per-height
evolution and validator changes) and checks the reference's assertions
on each; the stores' records must be equal across the two, byte for
byte: full records only at change and checkpoint heights, priorities
rebuilt at pointer heights, pruning that keeps the anchor (legacy
``S:vals`` records included), the legacy read path, a rollback across a
validator change that keeps history consistent, and the blocksync
pool's soft exclusion.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu import types as JT
from cometbft_tpu.blocksync import pool as jpool
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.node import inprocess as jinprocess
from cometbft_tpu.state import rollback as jrollback
from cometbft_tpu.state import state_types as jstate_types
from cometbft_tpu.state import store as jstore
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch.blocksync import pool as ppool
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.node import inprocess as pinprocess
from cometbft_tpu_torch.state import rollback as prollback
from cometbft_tpu_torch.state import state_types as pstate_types
from cometbft_tpu_torch.state import store as pstore
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import validator_set as pvalset
from cometbft_tpu_torch.utils import chaingen as pchaingen
from cometbft_tpu_torch.utils import codec as pcodec
from cometbft_tpu_torch.utils import kv as pkv
from torch_hard_limit import hard_limit  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(
        name="jax", BlockID=JT.BlockID, PartSetHeader=JT.PartSetHeader, Validator=JT.Validator,
        ValidatorSet=JT.ValidatorSet, Priv=JPriv, state_types=jstate_types, store=jstore,
        codec=jcodec, kv=jkv, inprocess=jinprocess, chaingen=jchaingen, rollback=jrollback,
        pool=jpool,
    ),
    "port": SimpleNamespace(
        name="port", BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader,
        Validator=pvalset.Validator, ValidatorSet=pvalset.ValidatorSet, Priv=PPriv,
        state_types=pstate_types, store=pstore, codec=pcodec, kv=pkv, inprocess=pinprocess,
        chaingen=pchaingen, rollback=prollback, pool=ppool,
    ),
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


def both(scenario, monkeypatch=None, interval=None):
    got = {}
    for name, pkg in PKGS.items():
        if interval is not None:
            monkeypatch.setattr(pkg.store, "VALSET_CHECKPOINT_INTERVAL", interval)
        got[name] = scenario(pkg)
    assert got["port"] == got["jax"]
    return got["port"]


def _valset(pkg, n, seed):
    rng = np.random.default_rng(seed)
    return pkg.ValidatorSet([pkg.Validator(pkg.Priv.from_seed(rng.bytes(32)).pub_key(), 100)
                             for _ in range(n)])


def _mk_state(pkg, vs, h, initial=1, changed=1):
    nvals = vs.copy()
    nvals.increment_proposer_priority(1)
    return pkg.state_types.State(
        chain_id="ptr-chain", initial_height=initial, last_block_height=h,
        last_block_id=pkg.BlockID(b"\x01" * 32, pkg.PartSetHeader(1, b"\x02" * 32)),
        last_block_time_ns=1000 + h, validators=vs, next_validators=nvals,
        last_validators=vs.copy(), last_height_validators_changed=changed,
        consensus_params=pkg.state_types.ConsensusParams(), app_hash=b"\x0b" * 32,
    )


def _evolve(pkg, store, vs0, n_heights, change_at=()):
    """The executor's per-height save loop from genesis; a change adds
    a validator whose key comes from default_rng(100 + height)."""
    state = _mk_state(pkg, vs0.copy(), 0, changed=1)
    store.save(state)  # the genesis save
    for h in range(1, n_heights + 1):
        nvals = state.next_validators.copy()
        changed = state.last_height_validators_changed
        if h in change_at:
            nvals.update_with_change_set([_valset(pkg, 1, 100 + h).validators[0]])
            changed = h + 2  # updates from block h take effect at h+2
        nvals.increment_proposer_priority(1)
        state = dataclasses.replace(
            state, last_block_height=h, validators=state.next_validators.copy(),
            next_validators=nvals, last_validators=state.validators.copy(),
            last_height_validators_changed=changed,
        )
        store.save(state)
    return state


def _rows(db):
    return sorted(db.iter_prefix(b""))


def test_pointer_records_written_for_unchanged_heights():
    def scenario(pkg):
        db = pkg.kv.MemKV()
        _evolve(pkg, pkg.store.Store(db), _valset(pkg, 4, 1), 20)
        full = pointer = 0
        for h in range(1, 23):
            raw = db.get(b"S:vi:" + h.to_bytes(8, "big"))
            assert raw is not None, h
            got, changed = pkg.store._decode_validators_info(raw)
            if got is None:
                pointer += 1
                assert changed == 1
            else:
                full += 1
        # genesis-adjacent records are full; the rest are pointers
        assert full <= 3 and pointer >= 19
        return full, pointer, _rows(db)

    both(scenario)


def test_load_reconstructs_priorities_at_pointer_heights():
    def scenario(pkg):
        vs = _valset(pkg, 5, 2)
        store = pkg.store.Store(pkg.kv.MemKV())
        state = _evolve(pkg, store, vs, 30)
        loads = []
        for h in (2, 7, 19, 31):
            got = store.load_validators(h)
            assert got is not None and got.hash() == vs.hash()
            loads.append(pkg.codec.encode_validator_set(got))
        # the live state's priorities round-trip exactly (no drift on
        # the consensus-resume path)
        loaded = store.load()
        for a, b in ((loaded.validators, state.validators),
                     (loaded.next_validators, state.next_validators),
                     (loaded.last_validators, state.last_validators)):
            assert [v.proposer_priority for v in a.validators] == [v.proposer_priority for v in b.validators]
            assert a.proposer.address == b.proposer.address
        assert loaded.last_block_height == state.last_block_height
        return loads

    both(scenario)


def test_valset_change_writes_full_record():
    def scenario(pkg):
        db = pkg.kv.MemKV()
        store = pkg.store.Store(db)
        _evolve(pkg, store, _valset(pkg, 4, 3), 12, change_at={6})
        got, changed = pkg.store._decode_validators_info(db.get(b"S:vi:" + (8).to_bytes(8, "big")))
        assert got is not None and changed == 8 and got.size() == 5
        assert store.load_validators(11).size() == 5  # from the new full record
        assert store.load_validators(6).size() == 4  # the old membership
        return _rows(db)

    both(scenario)


def test_checkpoint_bounds_reconstruction(monkeypatch):
    def scenario(pkg):
        vs = _valset(pkg, 3, 4)
        db = pkg.kv.MemKV()
        store = pkg.store.Store(db)
        _evolve(pkg, store, vs, 25)
        for cp in (10, 20):
            got, _ = pkg.store._decode_validators_info(db.get(b"S:vi:" + cp.to_bytes(8, "big")))
            assert got is not None, cp
        # a height just past a checkpoint rebuilds from it, not genesis
        assert store.load_validators(21).hash() == vs.hash()
        return _rows(db)

    both(scenario, monkeypatch, interval=10)


def test_prune_keeps_reconstruction_anchor(monkeypatch):
    def scenario(pkg):
        vs = _valset(pkg, 3, 5)
        db = pkg.kv.MemKV()
        store = pkg.store.Store(db)
        _evolve(pkg, store, vs, 25)
        store.prune_states(15)
        # the checkpoint at 10 (the anchor of pointers in [10, 20)) kept
        assert db.get(b"S:vi:" + (10).to_bytes(8, "big")) is not None
        assert store.load_validators(15).hash() == vs.hash()
        assert store.load_validators(22).hash() == vs.hash()
        assert db.get(b"S:vi:" + (5).to_bytes(8, "big")) is None
        return _rows(db)

    both(scenario, monkeypatch, interval=10)


def test_prune_keeps_legacy_anchor_of_upgraded_store(monkeypatch):
    """On a store upgraded from the legacy S:vals layout, prune_states
    with retain_height inside the legacy region keeps the legacy record
    post-upgrade pointers anchor at, and a backfilled full record in
    between does not mask the pointer's true anchor."""

    def scenario(pkg):
        vs = _valset(pkg, 3, 6)
        db = pkg.kv.MemKV()
        for h in range(1, 13):  # a legacy store: S:vals at 1..12
            db.set(b"S:vals:" + h.to_bytes(8, "big"), pkg.codec.encode_validator_set(vs))
        store = pkg.store.Store(db)
        store.save(_mk_state(pkg, vs.copy(), 12, changed=11))
        # the record at 14 is a pointer anchored at 11; save()
        # backfilled a full record at 13
        got14, changed14 = pkg.store._decode_validators_info(db.get(b"S:vi:" + (14).to_bytes(8, "big")))
        assert got14 is None and changed14 == 11
        store.prune_states(12)
        assert db.get(b"S:vals:" + (11).to_bytes(8, "big")) is not None
        assert store.load_validators(14).hash() == vs.hash()
        rows = _rows(db)
        # retain_height on the backfilled full record at 13: the scan
        # looks past full records
        store.prune_states(13)
        assert db.get(b"S:vals:" + (11).to_bytes(8, "big")) is not None
        assert store.load_validators(14).hash() == vs.hash()
        return rows, _rows(db)

    both(scenario, monkeypatch, interval=10)


def test_legacy_full_records_still_load():
    def scenario(pkg):
        vs = _valset(pkg, 4, 7)
        db = pkg.kv.MemKV()
        db.set(b"S:vals:" + (9).to_bytes(8, "big"), pkg.codec.encode_validator_set(vs))
        got = pkg.store.Store(db).load_validators(9)
        assert got is not None and got.hash() == vs.hash()
        return pkg.codec.encode_validator_set(got)

    both(scenario)


def test_rollback_across_valset_change_keeps_history_consistent():
    """A rollback after a validator-set change clamps
    last_height_validators_changed (reference rollback.go:69-76), so
    the next save writes no forward pointer over a correct record."""

    def scenario(pkg):
        gen, keys = pkg.inprocess.make_genesis(4, chain_id="rb-ptr")
        privs = [getattr(k, "priv_key", k) for k in keys]
        if pkg.name == "jax":
            node = pkg.inprocess.build_node(gen, None)
        else:
            node = pkg.inprocess.build_node(gen, device="cpu")
        make_chain = pkg.chaingen.make_chain
        make_chain(gen, privs, 5, node=node)
        # a validator-power update lands in block 6, effective at 8
        node.mempool.check_tx(b"val:%s!%d" % (privs[0].pub_key().key_bytes.hex().encode(), 25))
        make_chain(gen, privs, 1, node=node, txs_per_block=0)
        assert node.state_store.load().last_height_validators_changed == 8
        make_chain(gen, privs, 2, node=node)
        before = node.state_store.load_validators(7)
        assert before is not None
        rolled = pkg.rollback.rollback_state(node.state_store, node.block_store)
        assert rolled.last_block_height == 7 and rolled.last_height_validators_changed <= 9
        after = node.state_store.load_validators(7)
        assert after is not None and after.hash() == before.hash()
        reloaded = node.state_store.load()
        assert reloaded.last_block_height == 7
        assert reloaded.validators.hash() == rolled.validators.hash()
        # the two packages' genesis keys differ (the JAX make_genesis
        # draws them at random): the heights are compared
        return rolled.last_height_validators_changed, rolled.last_block_height, node.block_store.height()

    both(scenario)


def test_pool_soft_exclusion_steers_retry():
    """A refetch prefers a different peer (soft exclusion), but ignores
    the exclusion when no alternative exists (liveness)."""

    def scenario(pkg):
        pool = pkg.pool.BlockPool(1)
        pool.peers["fast"] = pkg.pool.PoolPeer("fast", object(), base=1, height=100, latency_ewma=0.01)
        pool.peers["slow"] = pkg.pool.PoolPeer("slow", object(), base=1, height=100, latency_ewma=0.9)
        picks = [pool._pick_peer(5).peer_id]
        pool.exclude_peer_for_height(5, "fast")
        picks += [pool._pick_peer(5).peer_id, pool._pick_peer(6).peer_id]
        pool.exclude_peer_for_height(5, "slow")
        assert pool._pick_peer(5) is not None  # all excluded: ignored
        pool.clear_exclusions(5)
        picks.append(pool._pick_peer(5).peer_id)
        assert picks == ["fast", "slow", "fast", "fast"]
        return picks

    both(scenario)
