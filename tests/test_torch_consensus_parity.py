"""Consensus and adaptive sync, port against the JAX package, on the CPU.

- Adaptive ingest: one genesis (4 validators, seeded keys, a fixed
  genesis time) and a 40-block chain made by each package's
  ``make_chain`` (byte-identical, ``test_torch_replay.py``); each
  package's ``BlockSyncReactor`` replays its own chain into its own
  started ``ConsensusState`` as the block ingestor. Every block enters
  through ``ingest_verified_block``, in the same order in both, and
  the states, block IDs and app hashes are equal at every height.
- Stub-driven heights: ``utils.chaingen.ValidatorStubs`` makes three
  heights of messages once (proposal, parts, 4 prevotes, 4
  precommits; one precommit forged at the second height); the port's
  node takes them as they are, the JAX package's node as its own codec
  decodes their bytes. Block hashes, app hashes, seen-commit bytes and
  the WAL's sequence of record kinds and heights are equal.
- WAL interchange: a WAL one package writes (every record kind, a
  rotated group) is read back record for record by the other, and the
  same records make the same bytes.
- Stand-in card (ROADMAP C3): the device route pinned on
  ``device="cpu"`` with ``ops.ed25519.verify_batch_async`` raising a
  ``RuntimeError``, a ``ValueError`` or an ``OSError``, at each of the
  places the JAX state machine takes an error for a verdict: the vote
  coalescer's callback (the wave's own route, and a polka's block check
  in ``_enter_precommit`` that the callback leads to), the
  ``commit_block`` catch-up and the prevote's block check. Each raises a ``DeviceRouteError`` chained to
  the card's error, which the receive routine counts; the round state
  is as it was and nothing is dropped as an invalid signature. A run
  with the card working is the control.

Exact equality everywhere: these are hashes and verdicts.
"""

import asyncio

import pytest
import torch

from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor
from cometbft_tpu.config.config import test_config as jtest_config
from cometbft_tpu.consensus import wal as jwal
from cometbft_tpu.consensus.state import BlockPartMessage as JBlockPartMessage
from cometbft_tpu.consensus.state import ProposalMessage as JProposalMessage
from cometbft_tpu.consensus.state import VoteMessage as JVoteMessage
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.node.inprocess import build_node as jbuild_node
from cometbft_tpu.store.block_store import _decode_part as jdecode_part
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.consensus import wal as pwal
from cometbft_tpu_torch.consensus.reactor import CommitBlockMessage
from cometbft_tpu_torch.consensus.state import TimeoutInfo, VoteMessage
from cometbft_tpu_torch.consensus.types import Step
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.store.block_store import _encode_part
from cometbft_tpu_torch.types.vote import PRECOMMIT, PREVOTE
from cometbft_tpu_torch.utils import chaingen, codec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
GENESIS_TIME_NS = 1_700_000_000_000_000_000
N_VALS = 4
N_BLOCKS = 40
STUB_HEIGHTS = 3
FORGED = {2: (1,)}  # height -> precommit lanes with a corrupted signature


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_min_device_batch(floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def _genesis(chain_id):
    gen, privs = make_genesis(N_VALS, chain_id=chain_id, genesis_time_ns=GENESIS_TIME_NS, seed=17)
    return gen, privs, JGenesisDoc.from_json(gen.to_json())


def _state_row(st):
    return (
        st.last_block_height,
        bytes(st.app_hash),
        bytes(st.last_results_hash),
        st.validators.hash(),
        st.next_validators.hash(),
        st.last_block_id.key(),
    )


def _config(pkg):
    """Long propose timeouts, so no timeout fires while a height is
    played (the WAL records them), and no wait after a commit."""
    cfg = jtest_config(".") if pkg == "jax" else make_test_cfg(".")
    cfg.consensus.timeout_propose_s = 30.0
    cfg.consensus.skip_timeout_commit = True
    cfg.consensus.vote_batch_window_ms = 2.0
    return cfg


# --- adaptive ingest ---------------------------------------------------------


def _adaptive(pkg, gen, src):
    async def main():
        if pkg == "jax":
            node = jbuild_node(gen, None)
            reactor_cls, peer = JReactor, jchaingen.StorePeerClient(src)
            kw = {}
        else:
            node = build_node(gen, device=CPU)
            reactor_cls, peer = BlockSyncReactor, chaingen.StorePeerClient(src)
            kw = {"device": CPU}
        cs = node.cs
        await cs.start()
        ingested, rows = [], []
        real = cs.ingest_verified_block

        def ingest(block, parts, commit):
            ingested.append(block.height)
            st = real(block, parts, commit)
            rows.append(_state_row(st))
            return st

        cs.ingest_verified_block = ingest
        caught = asyncio.Event()
        reactor = reactor_cls(node.state, node.block_exec, node.block_store,
                              on_caught_up=lambda st: caught.set(), block_ingestor=cs,
                              verify_window=8, **kw)
        reactor.pool.set_peer_range("src", peer, 1, src.block_store.height())
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 90)
        await reactor.stop()
        await cs.stop()
        ids = [node.block_store.load_block_meta(h).block_id.key()
               for h in range(1, node.block_store.height() + 1)]
        return ingested, rows, ids, node.app.app_hash, cs.rs.height

    return run(main())


def test_adaptive_ingest_matches_jax():
    gen, privs, jgen = _genesis("cs-ingest")
    src = chaingen.make_chain(gen, privs, N_BLOCKS, device=CPU)
    jsrc = jchaingen.make_chain(jgen, [JPriv.from_seed(p.seed) for p in privs], N_BLOCKS)
    ingested, rows, ids, app_hash, height = _adaptive("port", gen, src)
    jingested, jrows, jids, japp_hash, jheight = _adaptive("jax", jgen, jsrc)
    # the caught-up check runs between windows: compare what both did
    n = min(len(ingested), len(jingested))
    assert n >= N_BLOCKS - 2
    assert ingested[:n] == jingested[:n] == list(range(1, n + 1))
    assert ingested == list(range(1, len(ingested) + 1))
    assert rows[:n] == jrows[:n]
    assert ids[:n] == jids[:n]
    assert [r[0] for r in rows] == ingested and height == ingested[-1] + 1
    if len(ingested) == len(jingested):
        assert app_hash == japp_hash and height == jheight
    # against the source chain too
    assert all(ids[h - 1] == src.block_store.load_block_meta(h).block_id.key()
               for h in ingested)


# --- stub-driven heights -----------------------------------------------------


def _jax_deliver(jcs, m):
    """The port's messages as the JAX package decodes their bytes."""

    def deliver(kind, obj):
        if kind == "proposal":
            payload = JProposalMessage(jcodec.decode_proposal(codec.encode_proposal(obj)))
        elif kind == "block_part":
            payload = JBlockPartMessage(m.height, m.round, jdecode_part(_encode_part(obj)))
        else:
            payload = JVoteMessage(jcodec.decode_vote(codec.encode_vote(obj)))
        jcs.enqueue_nowait(kind, payload, "stubs")

    return deliver


def test_stub_driven_heights_match_jax(tmp_path, capsys):
    gen, privs, jgen = _genesis("cs-stubs")

    async def main():
        shadow = build_node(gen, device=CPU)
        stubs = chaingen.ValidatorStubs(shadow, privs)
        node = build_node(gen, device=CPU, config=_config("port"), home=str(tmp_path / "port"),
                          wal=True)
        jnode = jbuild_node(jgen, None, config=_config("jax"), home=str(tmp_path / "jax"),
                            wal=True)
        await node.cs.start()
        await jnode.cs.start()
        try:
            for h in range(1, STUB_HEIGHTS + 1):
                m = stubs.messages(h, forge=FORGED.get(h, ()))
                await stubs.play_height(node.cs, m)
                await stubs.play_height(jnode.cs, m, deliver=_jax_deliver(jnode.cs, m))
                stubs.finish(m)
            # the late precommits of the last height land in both
            await asyncio.sleep(0.2)
        finally:
            await node.cs.stop()
            await jnode.cs.stop()
        return shadow, node, jnode

    shadow, node, jnode = run(main())
    for h in range(1, STUB_HEIGHTS + 1):
        bid = shadow.block_store.load_block_meta(h).block_id
        assert node.block_store.load_block_meta(h).block_id == bid
        assert jnode.block_store.load_block_meta(h).block_id.key() == bid.key()
        seen = codec.encode_commit(node.block_store.load_seen_commit(h))
        assert seen == jcodec.encode_commit(jnode.block_store.load_seen_commit(h))
    assert node.app.app_hash == jnode.app.app_hash == shadow.state.app_hash
    assert node.state_store.load().app_hash == shadow.state.app_hash
    # the forged precommit was dropped by both, and signs nothing stored
    forged = FORGED[2][0]
    for n in (node, jnode):
        assert n.block_store.load_seen_commit(2).signatures[forged].signature == b""
        assert n.block_store.load_block(3).last_commit.signatures[forged].signature == b""
    # the port's drop (the JAX logger writes to the stream it found at
    # import, which the capture does not see)
    assert capsys.readouterr().err.count("dropping vote with invalid signature") == 1
    # the WAL: the same records, kind and height, in the same order
    seq = [(m.kind, m.height) for m in pwal.WAL.iter_messages(node.cs._wal_path)]
    jseq = [(m.kind, m.height) for m in jwal.WAL.iter_messages(jnode.cs._wal_path)]
    assert seq == jseq
    assert sum(k == pwal.MSG_END_HEIGHT for k, _ in seq) == STUB_HEIGHTS
    assert sum(k == pwal.MSG_VOTE for k, _ in seq) == STUB_HEIGHTS * 2 * N_VALS - 1


# --- WAL interchange ---------------------------------------------------------


def _records(mod):
    return [
        mod.WALMessage(kind=mod.MSG_TIMEOUT, height=1, round=0, step="1", time_ns=11),
        mod.WALMessage(kind=mod.MSG_PROPOSAL, height=1, round=2, data=b"\x01" * 90,
                       peer_id="node1", time_ns=12),
        mod.WALMessage(kind=mod.MSG_BLOCK_PART, height=1, data=b"p" * 700, peer_id="a" * 40,
                       time_ns=13),
        mod.WALMessage(kind=mod.MSG_VOTE, height=1, round=1, data=b"v" * 120, time_ns=14),
        mod.WALMessage(kind=mod.MSG_EVENT, height=1, step="prevote", time_ns=15),
        mod.WALMessage(kind=mod.MSG_END_HEIGHT, height=1, time_ns=16),
    ] * 8


def _fields(m):
    return (m.kind, m.height, m.round, m.step, m.data, m.peer_id, m.time_ns)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_interchange(tmp_path, writer):
    wmod, rmod = (pwal, jwal) if writer == "port" else (jwal, pwal)
    path = str(tmp_path / "wal")
    w = wmod.WAL(path, head_size_limit=2048)
    recs = _records(wmod)
    for m in recs:
        w.write(m)
    w.write_end_height(99)
    w.close()
    assert len(wmod._group_files(path)) > 2, "the head never rotated"
    got = list(rmod.WAL.iter_messages(path))
    want = list(wmod.WAL.iter_messages(path))
    assert [_fields(m) for m in got] == [_fields(m) for m in want]
    assert [_fields(m) for m in got[:-1]] == [_fields(m) for m in recs]
    assert rmod.WAL.search_for_end_height(path, 99) == len(recs) + 1
    # the other package writes the same bytes
    other = str(tmp_path / "other")
    w2 = rmod.WAL(other, head_size_limit=1 << 30)
    for m in _records(rmod):
        w2.write(m)
    w2.close()
    w3 = wmod.WAL(str(tmp_path / "same"), head_size_limit=1 << 30)
    for m in _records(wmod):
        w3.write(m)
    w3.close()
    with open(other, "rb") as a, open(str(tmp_path / "same"), "rb") as b:
        assert a.read() == b.read()


# --- the stand-in card (C3) --------------------------------------------------

CAUSES = {
    "cuda_error": RuntimeError("CUDA error: launch failed"),
    "shape_check": ValueError("ladder: rows 16 apart expected"),
    "library_load": OSError("libladder.so: cannot open shared object file"),
}


@pytest.fixture
def card(monkeypatch):
    """The device route pinned on the CPU; ``card["fault"] = <error>``
    makes every device dispatch raise it, but those whose kernel items
    ``card["spare"](items)`` lets through."""
    real = ops_ed.verify_batch_async
    state = {"fault": None, "failed": 0, "spare": None}

    def dispatch(items, device=None, precomp=None):
        spared = state["spare"] is not None and state["spare"](items)
        if state["fault"] is not None and not spared:
            state["failed"] += 1
            raise state["fault"]
        return real(items, device=device, precomp=precomp)

    monkeypatch.setattr(ops_ed, "verify_batch_async", dispatch)
    crypto_batch.set_min_device_batch(1)
    return state


def _snap(cs):
    rs = cs.rs
    votes = [
        sum(v is not None for v in vs.votes)
        for vs in (rs.votes.prevotes(rs.round), rs.votes.precommits(rs.round))
    ]
    return (rs.height, rs.round, int(rs.step), rs.locked_round, rs.valid_round,
            rs.commit_round, votes, cs.block_store.height())


async def _until(cond, what, timeout=60.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        assert loop.time() < deadline, what
        await asyncio.sleep(0.002)


async def _node_at_height_3(gen, privs, card, signer=None, window_ms=0.0):
    """A started node that took heights 1-2 by catch-up with the card
    working, and the stubs over a source chain at the same height.
    ``signer(src)`` picks the node's private validator."""
    src = chaingen.make_chain(gen, privs, 2, device=CPU)
    cfg = _config("port")
    cfg.consensus.vote_batch_window_ms = window_ms
    node = build_node(gen, device=CPU, config=cfg, privval=signer(src) if signer else None)
    await node.cs.start()
    # the setup's catch-up on the host plane; the card from height 3 on
    crypto_batch.set_min_device_batch(1 << 30)
    for h in (1, 2):
        node.cs.enqueue_nowait("commit_block", CommitBlockMessage(
            src.block_store.load_block(h), src.block_store.load_seen_commit(h)), "src")
    await _until(lambda: node.cs.rs.height == 3 and node.cs.rs.step >= Step.PROPOSE, "height 3")
    crypto_batch.set_min_device_batch(1)
    return node, chaingen.ValidatorStubs(src, privs)


def _held(node, card, cause, before, capsys):
    """The failing card's error reached the receive routine's count as
    a DeviceRouteError chained to it; nothing else moved."""
    errs = node.cs.loop_errors
    assert card["failed"] >= 1 and errs.count >= 1
    assert all(isinstance(e, DeviceRouteError) and e.__cause__ is cause for e in errs.kept())
    assert _snap(node.cs) == before
    assert "invalid signature" not in capsys.readouterr().err


@pytest.mark.parametrize("fault", [None, *CAUSES])
def test_failed_card_at_the_vote_wave(card, capsys, fault):
    """The coalescer's callback: a peer prevote whose wave fails is
    neither dropped as forged nor added."""
    gen, privs, _ = _genesis("c3-wave")

    async def main():
        node, stubs = await _node_at_height_3(gen, privs, card, window_ms=2.0)
        try:
            vote = stubs.messages(3).prevotes[1]
            before = _snap(node.cs)
            card["fault"] = CAUSES.get(fault)
            node.cs.enqueue_nowait("vote", VoteMessage(vote), "peer1")
            if fault is None:
                await _until(lambda: node.cs.rs.votes.prevotes(0).votes[1] is not None, "added")
                assert node.cs.loop_errors.count == 0
                assert node.cs._vote_coalescer.dispatches == 1
            else:
                await _until(lambda: node.cs.loop_errors.count >= 1, "counted")
                await asyncio.sleep(0.05)
                _held(node, card, card["fault"], before, capsys)
                assert node.cs.rs.votes.prevotes(0).votes[1] is None
        finally:
            await node.cs.stop()

    run(main())


@pytest.mark.parametrize("fault", [None, *CAUSES])
def test_failed_card_at_the_commit_block_catch_up(card, capsys, fault):
    """``_handle_commit_block``: a catch-up block whose commit check
    fails on the card is not dropped as invalid, nor ingested."""
    gen, privs, _ = _genesis("c3-catchup")

    async def main():
        node, stubs = await _node_at_height_3(gen, privs, card)
        try:
            m = stubs.messages(3)
            commit = stubs.finish(m)
            before = _snap(node.cs)
            card["fault"] = CAUSES.get(fault)
            node.cs.enqueue_nowait("commit_block", CommitBlockMessage(m.block, commit), "peer1")
            if fault is None:
                await _until(lambda: node.cs.rs.height == 4, "ingested")
                assert node.block_store.load_block_meta(3).block_id == commit.block_id
                assert node.cs.loop_errors.count == 0
            else:
                await _until(lambda: node.cs.loop_errors.count >= 1, "counted")
                _held(node, card, card["fault"], before, capsys)
                # the card answers again: the same message is taken
                card["fault"] = None
                node.cs.enqueue_nowait("commit_block", CommitBlockMessage(m.block, commit), "peer1")
                await _until(lambda: node.cs.rs.height == 4, "ingested after the card recovered")
        finally:
            await node.cs.stop()

    run(main())


@pytest.mark.parametrize("fault", [None, *CAUSES])
def test_failed_card_at_the_prevote_check(card, capsys, fault, tmp_path):
    """``_enter_prevote``: a complete proposal whose LastCommit check
    fails on the card gets no nil prevote; the step stays at PROPOSE."""
    gen, privs, _ = _genesis("c3-prevote")
    pvs = make_privvals(privs, root=str(tmp_path))

    def signer(src):
        # a validator that does not propose height 3
        proposer = src.state.validators.get_proposer().address
        return next(p for p in pvs if p.pub_key().address() != proposer)

    async def main():
        node, stubs = await _node_at_height_3(gen, privs, card, signer=signer)
        try:
            m = stubs.messages(3)
            idx, _ = node.cs.rs.validators.get_by_address(node.privval.pub_key().address())
            node.cs.enqueue_nowait("proposal", _pm(m.proposal), "stubs")
            for part in m.parts[:-1]:
                node.cs.enqueue_nowait("block_part", _bpm(m, part), "stubs")
            await _until(lambda: node.cs.rs.proposal is not None, "proposal")
            before = _snap(node.cs)
            assert before[2] == Step.PROPOSE
            card["fault"] = CAUSES.get(fault)
            node.cs.enqueue_nowait("block_part", _bpm(m, m.parts[-1]), "stubs")
            if fault is None:
                await _until(lambda: node.cs.rs.votes.prevotes(0).votes[idx] is not None, "prevote")
                own = node.cs.rs.votes.prevotes(0).votes[idx]
                assert own.type_ == PREVOTE and own.block_id == m.proposal.block_id
                assert node.cs.loop_errors.count == 0
            else:
                await _until(lambda: node.cs.loop_errors.count >= 1, "counted")
                _held(node, card, card["fault"], before, capsys)
                assert node.cs.rs.votes.prevotes(0).votes[idx] is None
                assert node.cs.rs.proposal_block is not None
        finally:
            await node.cs.stop()

    run(main())


@pytest.mark.parametrize("fault", [None, *CAUSES])
def test_failed_card_at_the_precommit_check(card, capsys, fault, tmp_path):
    """``_enter_precommit``: a polka, staged through the vote
    coalescer, on a block the node did not check at its prevote (the
    propose timeout fired first, so it prevoted nil). The wave's own
    route works; the block's LastCommit check fails on the card. The
    coalescer's callback counts the error: no nil precommit, no lock,
    the step not at PRECOMMIT; the prevote-wait timeout then retries."""
    gen, privs, _ = _genesis("c3-precommit")
    pvs = make_privvals(privs, root=str(tmp_path))

    def signer(src):
        proposer = src.state.validators.get_proposer().address
        return next(p for p in pvs if p.pub_key().address() != proposer)

    async def main():
        node, stubs = await _node_at_height_3(gen, privs, card, signer=signer, window_ms=2.0)
        cs = node.cs
        # only the test's own timeout message moves the round on
        cs.config.timeout_prevote_s = 30.0
        try:
            m = stubs.messages(3)
            idx, _ = cs.rs.validators.get_by_address(node.privval.pub_key().address())
            cs.enqueue_nowait("timeout", TimeoutInfo(0.0, 3, 0, Step.PROPOSE), "")
            await _until(lambda: cs.rs.votes.prevotes(0).votes[idx] is not None, "nil prevote")
            assert cs.rs.votes.prevotes(0).votes[idx].block_id.is_nil()
            cs.enqueue_nowait("proposal", _pm(m.proposal), "stubs")
            for part in m.parts:
                cs.enqueue_nowait("block_part", _bpm(m, part), "stubs")
            await _until(lambda: cs.rs.proposal_block is not None, "the proposal's block")
            assert Step.PREVOTE <= cs.rs.step < Step.PRECOMMIT
            wave = {v.sign_bytes(gen.chain_id) for v in m.prevotes}
            card["spare"] = lambda items: all(msg in wave for msg, _, _ in items)
            card["fault"] = CAUSES.get(fault)
            for i, v in enumerate(m.prevotes):
                if i != idx:
                    cs.enqueue_nowait("vote", VoteMessage(v), "peer1")
            if fault is None:
                await _until(lambda: cs.rs.votes.precommits(0).votes[idx] is not None, "precommit")
                own = cs.rs.votes.precommits(0).votes[idx]
                assert own.type_ == PRECOMMIT and own.block_id == m.proposal.block_id
                assert cs.rs.locked_round == 0 and cs.loop_errors.count == 0
                return
            await _until(lambda: cs.loop_errors.count >= 1, "counted")
            await asyncio.sleep(0.05)
            errs = cs.loop_errors
            assert card["failed"] >= 1
            assert all(isinstance(e, DeviceRouteError) and e.__cause__ is card["fault"]
                       for e in errs.kept())
            assert cs._vote_coalescer.dispatches >= 1
            # the verified prevotes stay in the set; nothing else moved
            assert sum(v is not None for v in cs.rs.votes.prevotes(0).votes) == N_VALS
            assert Step.PREVOTE <= cs.rs.step < Step.PRECOMMIT
            assert cs.rs.locked_round == -1 and cs.rs.locked_block is None
            assert all(v is None for v in cs.rs.votes.precommits(0).votes)
            assert (cs.rs.height, node.block_store.height()) == (3, 2)
            err = capsys.readouterr().err
            assert "invalid signature" not in err and "Traceback" not in err
            # the card answers again: the prevote-wait timeout retries
            card["fault"] = None
            cs.enqueue_nowait("timeout", TimeoutInfo(0.0, 3, 0, Step.PREVOTE_WAIT), "")
            await _until(lambda: cs.rs.votes.precommits(0).votes[idx] is not None, "retried")
            assert cs.rs.votes.precommits(0).votes[idx].block_id == m.proposal.block_id
        finally:
            await cs.stop()

    run(main())


def _pm(p):
    from cometbft_tpu_torch.consensus.state import ProposalMessage

    return ProposalMessage(p)


def _bpm(m, part):
    from cometbft_tpu_torch.consensus.state import BlockPartMessage

    return BlockPartMessage(m.height, m.round, part)
