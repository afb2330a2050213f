"""The port's evidence pool against the JAX package's, on the CPU.

One seeded 4-validator chain of 10 blocks is built in each package
from one genesis (evidence max age 4 blocks), and every piece of
evidence is made once in the port and moved to the JAX package as
bytes. Each package's pool (the port's on ``device="cpu"``) must give
the same verdict, error type and message, the same pending evidence
and the same stored records:

- the matrix: duplicate votes (valid, a forged signature, too old, an
  unknown validator, a power mismatch, votes that do not conflict) and
  light-client attacks (a lunatic fork from one and from two heights
  back, an equivocation fork of the real set, a fabricated header
  under the genuine commit, a common height ahead of the block, a
  claimed byzantine set, power or total power that differs from the
  derived one, a block not yet available locally, the real chain, a
  forged signature, too little trusted power);
- ``pending_evidence`` under byte limits, ``check_evidence``,
  ``update`` (committed markers, expiry of pending evidence) and
  ``prune_below`` (markers clamped to the max-age window).
"""

import dataclasses

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.evidence import pool as jpool
from cometbft_tpu.evidence import types as jev
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.evidence import pool as ppool
from cometbft_tpu_torch.evidence.types import DuplicateVoteEvidence
from cometbft_tpu_torch.light.types import LightBlock
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.utils import chaingen, kv
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
N_BLOCKS = 10
MAX_AGE = 4
EV_TIME = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture(scope="module")
def chains():
    """(port chain, JAX chain, raw keys, the port chain grown to 12
    blocks: the future of the other two)."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id="evidence-pool", seed=31)
        gen.consensus_params.evidence.max_age_num_blocks = MAX_AGE
        jgen = JGenesisDoc.from_json(gen.to_json())
        src = chaingen.make_chain(gen, privs, N_BLOCKS, device=CPU)
        jsrc = jchaingen.make_chain(jgen, [JPriv.from_seed(p.seed) for p in privs], N_BLOCKS)
        ahead = chaingen.make_chain(gen, privs, N_BLOCKS + 2, device=CPU)
    finally:
        pv.set_engine(None)
        eng.close()
    return src, jsrc, privs, ahead


def _pools(chains):
    src, jsrc, _, _ = chains
    return (
        ppool.EvidencePool(kv.MemKV(), src.state_store, src.block_store, device=CPU),
        jpool.EvidencePool(jkv.MemKV(), jsrc.state_store, jsrc.block_store),
    )


def _jax(ev):
    return jev.decode_evidence(ev.encode())


def _outcome(pool, ev):
    try:
        pool.add_evidence(ev)
    except Exception as e:  # the verdict under test, whatever its type
        return type(e).__name__, str(e)
    return "accepted", [e.hash() for e in pool.pending_evidence(1 << 20)]


def _records(db):
    return sorted(db.iter_prefix(b"EV:"))


# --- the matrix --------------------------------------------------------------


def _dup(chains, height=8, index=1, priv=None, power=10, corrupt=False, same=False):
    src, _, privs, _ = chains
    a, b = chaingen.equivocating_votes(priv or privs[index], index, "evidence-pool", height, 0,
                                       time_ns=EV_TIME)
    if same:
        b = a
    if corrupt:
        b.signature = bytes([b.signature[0] ^ 1]) + b.signature[1:]
    return DuplicateVoteEvidence.from_votes(a, b, power, 40, EV_TIME)


def _lca(chains, height=8, common=7, signers=(2, 3), node=None):
    src, _, privs, _ = chains
    node = node or src
    lb = chaingen.conflicting_block(node, privs, height,
                                    None if signers is None else [privs[i] for i in signers])
    return chaingen.light_attack(src, lb, common, timestamp_ns=EV_TIME)


def _fabricated(chains):
    src = chains[0]
    real = src.block_store.load_block(8)
    lb = LightBlock(dataclasses.replace(real.header, app_hash=b"\x55" * 32),
                    src.block_store.load_seen_commit(8), src.state_store.load_validators(8))
    return chaingen.light_attack(src, lb, 7, timestamp_ns=EV_TIME)


def _real(chains, common=7):
    src = chains[0]
    lb = LightBlock(src.block_store.load_block(8).header, src.block_store.load_seen_commit(8),
                    src.state_store.load_validators(8))
    return chaingen.light_attack(src, lb, common, timestamp_ns=EV_TIME)


def _edit(ev, **kw):
    return dataclasses.replace(ev, **kw)


def _forged_sig(chains):
    ev = _lca(chains)
    sigs = ev.conflicting_block.commit.signatures
    sigs[0] = dataclasses.replace(sigs[0], signature=bytes([sigs[0].signature[0] ^ 1]) + sigs[0].signature[1:])
    return ev


def _byz_power(chains):
    ev = _lca(chains)
    v = ev.byzantine_validators[0].copy()
    v.voting_power += 1
    return _edit(ev, byzantine_validators=[v] + ev.byzantine_validators[1:])


CASES = {
    "dup_valid": lambda c: _dup(c),
    "dup_forged_signature": lambda c: _dup(c, corrupt=True),
    "dup_too_old": lambda c: _dup(c, height=N_BLOCKS - MAX_AGE - 1),
    "dup_unknown_validator": lambda c: _dup(c, priv=Ed25519PrivKey.from_seed(b"\x07" * 32)),
    "dup_power_mismatch": lambda c: _dup(c, power=11),
    "dup_not_conflicting": lambda c: _dup(c, same=True),
    "lca_lunatic": lambda c: _lca(c),
    "lca_lunatic_two_back": lambda c: _lca(c, common=6),
    "lca_equivocation": lambda c: _lca(c, signers=None),
    "lca_fabricated_header": _fabricated,
    "lca_common_ahead": lambda c: _real(c, common=9),
    "lca_byzantine_set_mismatch": lambda c: _edit(_lca(c), byzantine_validators=_lca(c).byzantine_validators[:1]),
    "lca_byzantine_power_mismatch": _byz_power,
    "lca_total_power_mismatch": lambda c: _edit(_lca(c), total_voting_power=41),
    "lca_block_not_local": lambda c: _lca(c, height=N_BLOCKS + 2, common=9, node=c[3]),
    "lca_real_chain": _real,
    "lca_forged_signature": _forged_sig,
    "lca_too_little_trusted_power": lambda c: _lca(c, signers=(3,)),
}
ACCEPTED = {"dup_valid", "lca_lunatic", "lca_lunatic_two_back", "lca_equivocation"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdicts_match_jax(chains, case):
    ev = CASES[case](chains)
    pool, jp = _pools(chains)
    got, want = _outcome(pool, ev), _outcome(jp, _jax(ev))
    assert got == want
    assert (got[0] == "accepted") == (case in ACCEPTED), got
    assert _records(pool.db) == _records(jp.db)
    if case in ACCEPTED:
        # known evidence is not checked again
        pool.add_evidence(ev)
        assert pool.size() == jp.size() == 1


def test_attacks_slash_their_signers(chains):
    """The derived byzantine set: the lunatic fork's two signers, the
    equivocation fork's four, the same in both packages."""
    src, jsrc, privs, _ = chains
    for signers in ((2, 3), None):
        ev = _lca(chains, signers=signers)
        want = {privs[i].pub_key().address() for i in (signers or range(4))}
        assert {v.address for v in ev.byzantine_validators} == want
        jvals = jsrc.state_store.load_validators(7)
        derived = _jax(ev).byzantine_from(jvals)
        assert [(v.address, v.voting_power) for v in derived] == [
            (v.address, v.voting_power) for v in ev.byzantine_validators]


# --- pending, check, update, prune ---------------------------------------------


def _three(chains):
    return [_dup(chains), _lca(chains), _lca(chains, signers=None)]


def test_pending_evidence_byte_limits_match_jax(chains):
    pool, jp = _pools(chains)
    evs = _three(chains)
    for ev in evs:
        pool.add_evidence(ev)
        jp.add_evidence(_jax(ev))
    sizes = [len(ev.encode()) for ev in evs]
    for limit in (0, sizes[0] - 1, sizes[0], sizes[0] + sizes[1], sum(sizes) - 1, sum(sizes), 1 << 20):
        got = [e.hash() for e in pool.pending_evidence(limit)]
        assert got == [e.hash() for e in jp.pending_evidence(limit)], limit
    assert len(pool.pending_evidence(sum(sizes))) == 3


def _check(pool, evs):
    try:
        pool.check_evidence(evs)
    except Exception as e:  # the verdict under test
        return type(e).__name__, str(e)
    return "ok"


def test_check_evidence_matches_jax(chains):
    src = chains[0]
    pool, jp = _pools(chains)
    dup, lca, eq = _three(chains)
    pool.add_evidence(dup)
    jp.add_evidence(_jax(dup))
    cases = [
        [dup],  # pending: not checked again
        [lca, eq],  # unknown: verified
        [dup, dup],  # twice in one block
        [_dup(chains, corrupt=True)],  # unknown and refused
        [_fabricated(chains)],
    ]
    for evs in cases:
        assert _check(pool, evs) == _check(jp, [_jax(e) for e in evs])
    state = src.state_store.load()
    pool.update(state, [lca])
    jp.update(_jstate(chains), [_jax(lca)])
    committed = _check(pool, [lca])
    assert committed == _check(jp, [_jax(lca)]) == ("EvidenceError", "evidence already committed")


def _jstate(chains, height=None):
    st = chains[1].state_store.load()
    return st if height is None else dataclasses.replace(st, last_block_height=height)


def test_update_and_prune_below_match_jax(chains):
    src = chains[0]
    pool, jp = _pools(chains)
    dup, lca, eq = _three(chains)
    old = _dup(chains, height=N_BLOCKS - MAX_AGE, index=2)
    for ev in (dup, lca, eq, old):
        pool.add_evidence(ev)
        jp.add_evidence(_jax(ev))
    state = src.state_store.load()
    # committed markers at heights 3, 5 and 7; the next state's height
    # expires the oldest pending piece
    for h, ev in ((3, dup), (5, lca), (7, eq)):
        pool.update(dataclasses.replace(state, last_block_height=h), [ev])
        jp.update(_jstate(chains, h), [_jax(ev)])
    pool.update(dataclasses.replace(state, last_block_height=N_BLOCKS + 1), [])
    jp.update(_jstate(chains, N_BLOCKS + 1), [])
    assert pool.size() == jp.size() == 0
    assert _records(pool.db) == _records(jp.db)
    # clamped to the max-age window of the stored state (height 10)
    assert pool.prune_below(100) == jp.prune_below(100) == 2
    assert _records(pool.db) == _records(jp.db)
    assert [k for k, _ in _records(pool.db)] == [b"EV:comm:" + eq.hash()]
    assert pool.prune_below(0) == jp.prune_below(0) == 0
    # a pruned marker no longer stops the evidence; a kept one does
    assert _check(pool, [eq]) == _check(jp, [_jax(eq)]) == ("EvidenceError", "evidence already committed")
