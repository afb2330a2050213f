"""ABCI vote extensions end-to-end (reference ABCI 2.0:
ExtendVote/VerifyVoteExtension at consensus/state.go, ExtendedCommit
persistence store/store.go:481, ExtendedCommitInfo into
PrepareProposal).

The port of ``tests/test_vote_extensions.py``, each test with its JAX
counterpart's checks, on ``device="cpu"``. One test is reshaped:
the late joiner of ``test_blocksync_transfers_extended_commits`` joins
over p2p ``Node``s in the JAX package, which wait for the network
slice; here it syncs adaptively from a validator's store, then takes
the tip through the consensus catch-up message.
"""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import LocalNet, build_node, make_genesis, make_privvals
from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BlockID,
    CommitSig,
    ExtendedCommit,
    ExtendedCommitSig,
    PartSetHeader,
)
from cometbft_tpu_torch.types.vote import PRECOMMIT, Vote
from cometbft_tpu_torch.utils import codec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


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


def test_extended_commit_codec_roundtrip():
    ec = ExtendedCommit(
        height=5,
        round=1,
        block_id=BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32)),
        extended_signatures=[
            ExtendedCommitSig(
                block_id_flag=BLOCK_ID_FLAG_COMMIT,
                validator_address=b"\x03" * 20,
                timestamp_ns=123,
                signature=b"\x04" * 64,
                extension=b"ext-data",
                extension_signature=b"\x05" * 64,
            ),
            ExtendedCommitSig(),  # absent
        ],
    )
    got = codec.decode_extended_commit(codec.encode_extended_commit(ec))
    assert got == ec
    c = got.to_commit()
    assert c.signatures[0].signature == b"\x04" * 64
    assert not hasattr(c.signatures[0], "extension") or isinstance(
        c.signatures[0], CommitSig
    )


def test_net_produces_verified_extensions():
    """4-node net with extensions enabled from height 1: every commit
    carries app-authored extensions, peers' extensions pass signature +
    app verification, and the proposer feeds them to PrepareProposal."""

    async def main():
        gen, privs = make_genesis(4, chain_id="ext-chain")
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        nodes = [build_node(gen, privval=pv, device=CPU) for pv in make_privvals(privs)]
        net = LocalNet(nodes)
        await net.start()
        await net.wait_for_height(3, timeout=60)
        await net.stop()

        vs = gen.validator_set()
        for n in nodes:
            # extended commits persisted for committed heights
            for h in (1, 2):
                raw = n.block_store.load_extended_commit(h)
                assert raw, f"no extended commit at {h}"
                ec = codec.decode_extended_commit(raw)
                n_ext = 0
                bid_hash = n.block_store.load_block_meta(h).block_id.hash
                for i, s in enumerate(ec.extended_signatures):
                    if not s.for_block():
                        continue
                    assert s.extension.startswith(b"ext|%d|" % h)
                    # extension signature verifies against the valset
                    val = vs.get_by_index(i)
                    v = Vote(
                        type_=PRECOMMIT,
                        height=h,
                        round=ec.round,
                        block_id=ec.block_id,
                        timestamp_ns=s.timestamp_ns,
                        validator_address=s.validator_address,
                        validator_index=i,
                        extension=s.extension,
                        extension_signature=s.extension_signature,
                    )
                    assert val.pub_key.verify(
                        v.extension_sign_bytes(gen.chain_id),
                        s.extension_signature,
                    )
                    n_ext += 1
                assert n_ext * 3 > vs.size() * 2
            # peers' extensions were app-verified
            assert n.app.extensions_verified > 0

    run(main())


def test_blocksync_transfers_extended_commits():
    """A late joiner receives + verifies extended commits with the
    blocks (reference blocksync BlockResponse.ExtCommit), so it could
    propose with ExtendedCommitInfo immediately. The JAX test joins
    over p2p ``Node``s, which wait for the network slice: here the
    joiner syncs adaptively from a validator's store (blocksync into
    its consensus state machine), then takes the tip through the
    consensus catch-up message, the two paths a p2p joiner uses."""
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.consensus.reactor import CommitBlockMessage
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient

    async def main():
        gen, privs = make_genesis(2, chain_id="ext-sync")
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        vals = [build_node(gen, privval=pv, device=CPU) for pv in make_privvals(privs)]
        net = LocalNet(vals)
        await net.start()
        await net.wait_for_height(4, timeout=60)
        await net.stop()
        src = vals[0]
        top = src.block_store.height()

        late = build_node(gen, device=CPU)
        await late.cs.start()
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            late.state,
            late.block_exec,
            late.block_store,
            on_caught_up=lambda st: caught.set(),
            block_ingestor=late.cs,
            device=CPU,
        )
        reactor.pool.set_peer_range("v0", StorePeerClient(src), 1, top)
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 60)
        await reactor.stop()
        # the tip (and whatever blocksync left) through consensus
        # catch-up, with the sender's extended commit
        for h in range(late.cs.rs.height, top + 1):
            late.cs.enqueue_nowait(
                "commit_block",
                CommitBlockMessage(
                    src.block_store.load_block(h),
                    src.block_store.load_seen_commit(h),
                    src.block_store.load_extended_commit(h),
                ),
                "v0",
            )
        dl = asyncio.get_running_loop().time() + 30
        while late.block_store.height() < top:
            assert asyncio.get_running_loop().time() < dl, "late sync"
            await asyncio.sleep(0.02)
        await late.cs.stop()

        # EVERY commit path persists the EC (reference
        # SaveBlockWithExtendedCommit): blocksync saves it with each
        # applied block, and the consensus catch-up message ships it
        # — so the late joiner can itself serve ECs to future joiners
        # at every height it holds
        assert late.block_store.height() >= 3
        for h in range(1, late.block_store.height() + 1):
            raw = late.block_store.load_extended_commit(h)
            assert raw, f"no extended commit persisted at height {h}"
            ec = codec.decode_extended_commit(raw)
            assert any(
                s.extension.startswith(b"ext|%d|" % h)
                for s in ec.extended_signatures
                if s.for_block()
            )
        assert reactor.blocks_applied > 0 and reactor.loop_errors.count == 0

    run(main())


def test_bad_extension_signature_rejected():
    async def main():
        gen, privs = make_genesis(2, chain_id="ext-rej")
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        pvs = make_privvals(privs)
        parts = build_node(gen, privval=pvs[0], device=CPU)
        cs = parts.cs
        await cs.start()
        try:
            rs = cs.rs
            pv = pvs[1]
            idx, _ = gen.validator_set().get_by_address(
                pv.pub_key().address()
            )
            bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
            import time as _t

            vote = Vote(
                type_=PRECOMMIT,
                height=rs.height,
                round=0,
                block_id=bid,
                timestamp_ns=_t.time_ns(),
                validator_address=pv.pub_key().address(),
                validator_index=idx,
            )
            vote.extension = b"ext|%d|XXXXXXXX" % rs.height
            pv.sign_vote(gen.chain_id, vote)
            # tamper the extension AFTER signing: main sig valid,
            # extension sig missing/invalid
            vote.extension_signature = b"\x00" * 64
            cs._try_add_vote(vote, "peerX")
            assert rs.votes.precommits(0).get_vote(idx) is None

            # missing extension signature entirely is also rejected
            vote2 = Vote(
                type_=PRECOMMIT,
                height=rs.height,
                round=0,
                block_id=bid,
                timestamp_ns=_t.time_ns(),
                validator_address=pv.pub_key().address(),
                validator_index=idx,
            )
            pv.sign_vote(gen.chain_id, vote2)
            vote2.extension_signature = b""
            cs._try_add_vote(vote2, "peerX")
            assert rs.votes.precommits(0).get_vote(idx) is None
        finally:
            await cs.stop()

    run(main())


def test_blocksync_tolerates_peers_lacking_extended_commits():
    """ADVICE r2 (medium) + ADVICE r3 (low): an honest peer may hold
    blocks WITHOUT their extended commits (it pruned them, or tolerated
    missing ECs while syncing itself). Blocksync must distinguish that
    from a bad EC: retry without banning, then apply bare once every
    reachable peer came back EC-less — but ONLY for historical heights.
    The switch-to-consensus tip is never applied bare (a node that did
    so could neither propose at tip+1 nor serve the EC to later
    joiners); the joiner switches to consensus one block early and
    fetches the tip through consensus catch-up instead."""
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain

    async def main():
        gen, privs = make_genesis(3, chain_id="ext-miss")
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        # chaingen signs plain commits only: the stores hold NO extended
        # commits at any height, exactly the stalling scenario
        src = make_chain(gen, privs, 10, device=CPU)
        assert src.block_store.load_extended_commit(3) is None

        fresh = build_node(gen, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            device=CPU,
        )
        reactor.pool.set_peer_range(
            "src", StorePeerClient(src), 1, src.block_store.height()
        )
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 60)
        await reactor.stop()
        # historical heights applied bare; the tip (max_peer_height-1,
        # the highest height blocksync can verify) deliberately NOT
        assert fresh.block_store.height() == src.block_store.height() - 2
        # the peer was never banned for lacking ECs
        assert not reactor.pool.banned_peers()

    run(main())


def test_blocksync_requires_distinct_peers_for_bare_apply():
    """ADVICE r3 (low): a single byzantine peer that wins every refetch
    must not force a bare apply while other peers exist — the EC-less
    tolerance counts DISTINCT peers, so the refetch (with the bare
    peer soft-excluded) reaches the honest peer, whose extended commit
    is applied."""
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain

    async def main():
        gen, privs = make_genesis(3, chain_id="ext-distinct")
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        src = make_chain(gen, privs, 10, device=CPU)
        # sign valid extended commits for the generated chain (chaingen
        # itself signs plain commits only)
        addr_to_priv = {p.pub_key().address(): p for p in privs}
        from cometbft_tpu_torch.types.canonical import vote_extension_sign_bytes

        for h in range(1, src.block_store.height() + 1):
            commit = src.block_store.load_seen_commit(h)
            ext_sigs = []
            for s in commit.signatures:
                ext = b"ext|%d|" % h
                esig = addr_to_priv[s.validator_address].sign(
                    vote_extension_sign_bytes(
                        gen.chain_id, h, commit.round, ext
                    )
                )
                ext_sigs.append(
                    ExtendedCommitSig(
                        block_id_flag=s.block_id_flag,
                        validator_address=s.validator_address,
                        timestamp_ns=s.timestamp_ns,
                        signature=s.signature,
                        extension=ext,
                        extension_signature=esig,
                    )
                )
            ec = ExtendedCommit(
                height=h,
                round=commit.round,
                block_id=commit.block_id,
                extended_signatures=ext_sigs,
            )
            src.block_store.save_extended_commit(
                h, codec.encode_extended_commit(ec)
            )

        class BarePeer(StorePeerClient):
            """Serves the same blocks but stripped of ECs."""

            async def request_block(self, height):
                blk = await super().request_block(height)
                if blk is not None and hasattr(blk, "_ec_bytes"):
                    del blk._ec_bytes
                return blk

        fresh = build_node(gen, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            device=CPU,
        )
        reactor.pool.set_peer_range(
            "bare", BarePeer(src), 1, src.block_store.height()
        )
        reactor.pool.set_peer_range(
            "honest", StorePeerClient(src), 1,
            src.block_store.height(),
        )
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 60)
        await reactor.stop()
        assert (
            fresh.block_store.height() >= src.block_store.height() - 2
        )
        # every applied extension-height block carries its EC (no bare
        # applies happened: the honest peer existed)
        for h in range(1, fresh.block_store.height() + 1):
            assert fresh.block_store.load_extended_commit(h) is not None, h

    run(main())
