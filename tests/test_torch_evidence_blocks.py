"""Blocks that carry evidence, in the port and the JAX package, on the
CPU.

- Codec: the reference case ``tests/test_store_abci.py::
  test_evidence_codec_roundtrip`` ported, and evidence and blocks with
  evidence encode byte-identically in both packages and decode across
  them.
- Execution: the same duplicate-vote and light-client-attack evidence
  handed to each package's pool on one seeded 4-validator chain; the
  next proposal carries it, the blocks equal the JAX package's byte for
  byte (the header's evidence hash included), ``evidence_to_misbehavior``
  gives the same records, every app's ``misbehavior_seen`` is the same,
  and the pool moves the evidence from pending to committed.
- Replay: that chain replayed into a fresh node through blocksync's
  windows and through the adaptive ingest into a started consensus
  state, against the JAX package's replay of its own: the same state at
  every height, and every replayed height's misbehavior reaches the
  app.
"""

import asyncio
import dataclasses
import hashlib

import pytest
import torch

from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.evidence import types as jev
from cometbft_tpu.node.inprocess import build_node as jbuild_node
from cometbft_tpu.state import execution as jexecution
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.evidence.types import DuplicateVoteEvidence, decode_evidence
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.state.execution import evidence_to_misbehavior
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import PREVOTE, Vote
from cometbft_tpu_torch.utils import chaingen, codec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
CHAIN = "evidence-blocks"
BEFORE, AFTER = 6, 4  # blocks before the evidence is handed in, and after
EV_AT = BEFORE + 1  # the block that carries it
EV_TIME = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _evidence(src, privs):
    """A duplicate vote by validator 1 at height 5 and a lunatic fork of
    height 5 signed by validators 2 and 3, from height 4."""
    a, b = chaingen.equivocating_votes(privs[1], 1, CHAIN, 5, 0, time_ns=EV_TIME)
    dup = DuplicateVoteEvidence.from_votes(a, b, 10, 40, EV_TIME)
    fork = chaingen.conflicting_block(src, privs, 5, [privs[2], privs[3]])
    return [dup, chaingen.light_attack(src, fork, 4, timestamp_ns=EV_TIME)]


@pytest.fixture(scope="module")
def chains():
    """The port's and the JAX package's chain of BEFORE + AFTER blocks
    from one genesis, the evidence handed to each pool after BEFORE;
    with the misbehavior records each app kept."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id=CHAIN, seed=41)
        jgen = JGenesisDoc.from_json(gen.to_json())
        jprivs = [JPriv.from_seed(p.seed) for p in privs]
        src = chaingen.make_chain(gen, privs, BEFORE, device=CPU)
        jsrc = jchaingen.make_chain(jgen, jprivs, BEFORE)
        evs = _evidence(src, privs)
        for ev in evs:
            src.evpool.add_evidence(ev)
            jsrc.evpool.add_evidence(jev.decode_evidence(ev.encode()))
        chaingen.make_chain(gen, privs, AFTER, node=src)
        jchaingen.make_chain(jgen, jprivs, AFTER, node=jsrc)
    finally:
        pv.set_engine(None)
        eng.close()
    return gen, jgen, src, jsrc, evs


# --- codec ------------------------------------------------------------------


def test_evidence_codec_roundtrip():
    """The reference case (tests/test_store_abci.py), in the port."""
    _, privs = make_genesis(2, chain_id=CHAIN, seed=3)
    votes = []
    for tag in (b"a", b"b"):
        bid = BlockID(hashlib.sha256(tag).digest(), PartSetHeader(1, hashlib.sha256(tag + b"p").digest()))
        v = Vote(type_=PREVOTE, height=4, round=0, block_id=bid, timestamp_ns=EV_TIME,
                 validator_address=privs[0].pub_key().address(), validator_index=0)
        v.signature = privs[0].sign(v.sign_bytes(CHAIN))
        votes.append(v)
    ev = DuplicateVoteEvidence.from_votes(votes[0], votes[1], 100, 200, EV_TIME)
    ev.validate_basic()
    dec = decode_evidence(ev.encode())
    assert dec.hash() == ev.hash()
    assert dec.vote_a.signature == ev.vote_a.signature
    # and across the packages
    jdec = jev.decode_evidence(ev.encode())
    assert jdec.hash() == ev.hash() and jdec.encode() == ev.encode()


def test_blocks_with_evidence_are_byte_identical(chains):
    _, _, src, jsrc, evs = chains
    top = src.block_store.height()
    assert top == jsrc.block_store.height() == BEFORE + AFTER
    for h in range(1, top + 1):
        blk, jblk = src.block_store.load_block(h), jsrc.block_store.load_block(h)
        raw = codec.encode_block(blk)
        assert raw == jcodec.encode_block(jblk), h
        assert codec.encode_block(codec.decode_block(jcodec.encode_block(jblk))) == raw
        assert jcodec.encode_block(jcodec.decode_block(raw)) == raw
        assert len(blk.evidence) == (len(evs) if h == EV_AT else 0), h
    blk = src.block_store.load_block(EV_AT)
    assert [e.hash() for e in blk.evidence] == [e.hash() for e in evs]
    blk.validate_basic()


def test_misbehavior_reaches_the_app_as_in_jax(chains):
    _, _, src, jsrc, evs = chains
    recs = evidence_to_misbehavior(evs)
    jrecs = jexecution.evidence_to_misbehavior([jev.decode_evidence(e.encode()) for e in evs])
    assert [dataclasses.astuple(r) for r in recs] == [dataclasses.astuple(r) for r in jrecs]
    assert [r.type_ for r in recs] == [abci.MISBEHAVIOR_DUPLICATE_VOTE] + [
        abci.MISBEHAVIOR_LIGHT_CLIENT_ATTACK] * 2
    want = [(EV_AT, r.type_, r.validator_address, r.validator_power, r.height) for r in recs]
    assert src.app.misbehavior_seen == jsrc.app.misbehavior_seen == want
    # committed: out of pending, marked, and refused if proposed again
    assert src.evpool.size() == jsrc.evpool.size() == 0
    assert sorted(src.evpool.db.iter_prefix(b"EV:")) == sorted(jsrc.evpool.db.iter_prefix(b"EV:"))
    with pytest.raises(Exception, match="already committed"):
        src.evpool.check_evidence(evs[:1])


# --- replay -----------------------------------------------------------------


def _row(st):
    return (st.last_block_height, bytes(st.app_hash), bytes(st.last_results_hash),
            st.validators.hash(), st.last_block_id.key())


def _replay(pkg, gen, src, ingest):
    """Replay ``src`` into a fresh node of ``pkg``, through blocksync's
    windows or the adaptive ingest; (state rows, the app's misbehavior
    records)."""
    async def main():
        if pkg == "jax":
            node, reactor_cls, peer, kw = jbuild_node(gen, None), JReactor, jchaingen.StorePeerClient(src), {}
        else:
            node, reactor_cls = build_node(gen, device=CPU), BlockSyncReactor
            peer, kw = chaingen.StorePeerClient(src), {"device": CPU}
        rows = []
        if ingest:
            cs = node.cs
            await cs.start()
            real = cs.ingest_verified_block

            def take(block, parts, commit):
                st = real(block, parts, commit)
                rows.append(_row(st))
                return st

            cs.ingest_verified_block = take
            kw["block_ingestor"] = cs
        else:
            real = node.block_exec.apply_verified_block

            def take(state, bid, block):
                st = real(state, bid, block)
                rows.append(_row(st))
                return st

            node.block_exec.apply_verified_block = take
        caught = asyncio.Event()
        reactor = reactor_cls(node.state, node.block_exec, node.block_store,
                              on_caught_up=lambda st: caught.set(), verify_window=3, **kw)
        reactor.pool.set_peer_range("src", peer, 1, src.block_store.height())
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 90)
        await reactor.stop()
        if ingest:
            await node.cs.stop()
        return rows, list(node.app.misbehavior_seen)

    return run(main())


@pytest.mark.parametrize("ingest", [False, True], ids=["windows", "ingest"])
def test_replay_carries_evidence_as_in_jax(chains, ingest):
    gen, jgen, src, jsrc, _ = chains
    rows, seen = _replay("port", gen, src, ingest)
    jrows, jseen = _replay("jax", jgen, jsrc, ingest)
    # the caught-up check runs between windows: compare what both did
    n = min(len(rows), len(jrows))
    assert n > EV_AT
    assert [r[0] for r in rows[:n]] == list(range(1, n + 1))
    assert rows[:n] == jrows[:n]
    assert seen == jseen == src.app.misbehavior_seen
